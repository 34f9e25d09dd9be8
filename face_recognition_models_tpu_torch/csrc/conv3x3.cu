// 3x3, stride 1, SAME-padded NHWC convolution for Hopper (sm_90a), as an
// implicit GEMM.
//
// Counterpart of the Pallas kernel in face_recognition_models_tpu/ops/
// conv3x3.py (_kernel, :42, called through conv3x3_same at :83):
//   conv3x3_same_bf16        <- _kernel with bf16 x (the benchmarked case),
//                               for C and C_out multiples of 8
//   conv3x3_same_bf16_ragged <- the same, for any other C or C_out
//   conv3x3_same_f32         <- _kernel with fp32 x, for C and C_out
//                               multiples of 4
//   conv3x3_same_f32_ragged  <- the same, for any other C or C_out
//
// Over the flattened rows r = n*H*W + h*W + w,
//   y[r, :] = sum_{a, b in {-1, 0, 1}} x[n, h + a, w + b, :] @ K[a + 1, b + 1]
// with x taken as 0 outside the image: a GEMM with M = N*H*W rows,
// N = C_out columns and K = 9*C, whose A operand is never materialised. The
// Pallas kernel rolls the flattened tile and masks the rows the roll wraps
// (a workaround for Mosaic's missing bf16 rotate); here each staged row
// computes its own source (h + a, w + b) and loads zeros where that falls
// outside the image. Within an image the source of row r for tap (a, b) is
// row r + a*W + b, so a row needs only its own (h, w) and r.
//
// What bounds it: at the ResNet-50 stage shapes of the benchmark (batch 512:
// 28x28x128, 14x14x256, 7x7x512, C_out = C) each conv is 2*M*9*C*C_out =
// 118-119 GFLOP against 51-103 MB of bf16 x, y and weight, so it is bound by
// operations: 0.12 ms at 989 TFLOP/s dense bf16. In fp32 (208 MB at
// 14x14x256) the 16-byte route computes each product as three tf32
// products: 0.72 ms at 495 TFLOP/s dense tf32, still bound by operations.
//
// conv3x3_same_bf16 (conv3x3_bf16_kernel). A block of 256 threads, two
// warpgroups, owns a 128-row x 128-channel tile of y and runs K as 9 taps x
// ceil(C / 64) chunks of 64 input channels. Each K step stages, with
// 16-byte cp.async.cg copies into a 3-stage ring in dynamic shared memory
// (32 KB a stage, two blocks per SM):
//   - A [128 rows][64 channels], K-major: the shifted rows of x; a row whose
//     source falls outside the image or past M, or a segment past C, is
//     zero-filled through the copy's source size of 0 (no branch on data);
//   - B [64 channels][128 outputs], MN-major: rows (tap, c0..c0 + 63) of the
//     weight as it lies, [9][C][C_out], in two halves of 64 outputs.
// Rows are 128 bytes, XOR-swizzled in 16-byte chunks by row % 8 on a
// 1024-byte-aligned ring: the hardware's 128-byte swizzle, so that
// warpgroup g runs wgmma.m64n128k16 on rows 64 g.. of A and all of B from
// shared memory through matrix descriptors (B's with the transpose bit), 4
// k steps a stage, into 64 fp32 accumulators a thread. The copies of stage k + 2 run under the
// products of stage k. The epilogue rounds the accumulators to bf16 into a
// shared tile and stores y 16 bytes a thread. The 16-byte copies need
// C % 8 == 0 and C_out % 8 == 0; the wrapper takes the ragged kernel below
// for other widths. Every thread stages and waits on the products at each
// stage: no TMA and no warp specialisation yet.
//
// conv3x3_same_f32 (conv3x3_f32_split_w_kernel, then conv3x3_f32_tc_kernel):
// fp32 to fp32 accuracy on the tensor cores, as 3xTF32. Each operand v is
// split into big = tf32(v) and small = tf32(v - big) (cvt.rna), and each
// product a.b is taken as a_small.b_big + a_big.b_small + a_big.b_big; the
// dropped a_small.b_small and the rounding of the small parts leave about
// 2^-21 of |a.b|. tf32 wgmma reads shared-memory operands K-major only, so
// a pre-pass reads the weight [9][C][C_out] once and writes w_big and
// w_small, each [9][C_out][Cp] with C padded to Cp, a multiple of 32 (zeros
// past C), into the workspace the wrapper hands in. The main kernel keeps
// the bf16 kernel's skeleton: 256 threads own a 128 x 128 tile of y, K runs
// as 9 taps x Cp / 32 chunks of 32 channels (one 128-byte fp32 row), and
// 16-byte cp.async copies fill a 4-stage ring (50 KB a stage, one block per
// SM): w_big and w_small [128 outputs][32 channels] 128-byte swizzled for
// the descriptors, and the shifted x rows [128][32] zero-filled as above, at
// a pitch of 36 floats. The two warpgroups never meet at a block barrier in
// the loop: each stage has an mbarrier `full` (every thread's copies into
// it landed, through cp.async.mbarrier.arrive) and an mbarrier `empty` (the
// 8 warps are done reading it). A thread issues its copies of stage i + 3
// once its stage-i products are issued, into the buffer both warpgroups
// have left after stage i - 1, so one warpgroup's splitting, adds and
// copies run under the other's products. x is not read through a
// descriptor: each thread loads its A fragments with plain shared loads
// (the pitch makes them conflict-free), splits them in registers, and
// warpgroup g issues, per k step of 8, three wgmma.m64n128k8.tf32 with A
// from registers: a_small.B_big, a_big.B_small, a_big.B_big (small terms
// first). The 12
// products of a stage go into 64 fresh fp32 accumulators, which are added
// to the thread's 64 running sums with IEEE fp32 adds once the stage's
// products are done: the tensor cores' own fp32 accumulation may round
// differently from IEEE (toward zero, if it truncates as earlier cards
// did), and over 9*C terms that bias would exceed the fp32 tolerances, while
// over the 96 products of one stage it stays far inside them. The epilogue
// writes the sums through a shared tile and stores y 16 bytes a thread.
// The 16-byte copies need C % 4 == 0 and C_out % 4 == 0.
//
// conv3x3_same_bf16_ragged (conv3x3_bf16_ragged_kernel) and
// conv3x3_same_f32_ragged (conv3x3_f32_ragged_kernel): a block of 256
// threads computes a 64-row x 64-channel tile of y. It loops over the 9
// taps x chunks of 32 input channels, staging into shared memory the
// masked, shifted rows of x ([64][32]) and the matching chunk of the weight
// ([32][64]) with synchronous loads, 8 channels a thread.
//   - bf16: 8 warps, each a 16 x 32 part of the tile as two nvcuda::wmma
//     16x16x16 bf16 fragments with fp32 accumulators on the tensor cores;
//     the accumulators meet in an fp32 tile and leave rounded to bf16.
//   - fp32: IEEE fp32 FMAs on the CUDA cores (no TF32), each thread a 4 x 4
//     register tile.
// The accumulation is fp32 in all four, over the taps in order (a, b) =
// (-1, -1), (-1, 0), ..., (1, 1) and then the channels; the output is in
// x's dtype. Forward only (the JAX kernel has no VJP).
//
// C interface: each entry launches on the given stream and returns
// cudaGetLastError(). x [N, H, W, C], w [9, C, C_out] (tap-major, the
// layout of K.reshape(9, C, C_out)) and y [N, H, W, C_out] are contiguous
// device arrays of the entry's type; conv3x3_same_bf16 needs x, w and y
// 16-byte aligned, conv3x3_same_f32 x, y and its fp32 workspace of
// 2 * 9 * C_out * Cp values (conv3x3_f32_workspace).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "tensor_core.cuh"

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBM = 64;   // rows of y per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBK = 32;   // input channels per staged chunk
constexpr int kPadA = 8;  // bf16 row padding of the staged tiles

// ---- conv3x3_same_bf16: the 16-byte route (see the note at the head) ---

constexpr int kTM = 128;    // rows of y per block (a warpgroup per 64)
constexpr int kTN = 128;    // output channels per block
constexpr int kTK = 64;     // input channels per K step: 128-byte rows
constexpr int kRing = 3;    // cp.async stages
constexpr int kStageA = kTM * kTK;   // bf16 elements of a staged x tile
constexpr int kStage = kStageA + kTN * kTK;   // and of a whole stage
constexpr int kHalfB = 64 * kTK;     // bf16 elements of 64 outputs of B
constexpr int kOutPitch = kTN + 8;   // bf16 pitch of the epilogue's y tile
// the ring, and room to put it on 1024 bytes (the swizzle's atom)
constexpr size_t kRingBytes = sizeof(bf16) * kRing * kStage + 1024;
static_assert(kTM * kTK / 8 == 4 * kThreads && kTN * kTK / 8 == 4 * kThreads,
              "four 16-byte copies of each tile a thread");
static_assert(sizeof(bf16) * kTM * kOutPitch <= kRingBytes - 1024,
              "the y tile fits in the ring");

__global__ void __launch_bounds__(kThreads, 2)
conv3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w9,
                    bf16* __restrict__ y, int n, int hh, int ww, int c,
                    int co) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  bf16* ring =
      reinterpret_cast<bf16*>(smem_raw + (((raw + 1023) & ~1023u) - raw));
  const int m = n * hh * ww;
  const int ntiles = (co + kTN - 1) / kTN;
  const int m0 = (blockIdx.x / ntiles) * kTM;
  const int co0 = (blockIdx.x % ntiles) * kTN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // staging A: thread -> 16-byte chunk tid % 8 (8 channels) of rows
  // tid / 8 + 32 j; each x row's flat index r and (h, w), h = -4 past M (no
  // tap reaches in). B: thread -> 16-byte chunk tid % 16 (8 outputs) of
  // channel rows tid / 16 + 16 j.
  const int seg = tid & 7;
  int ar[4], ah[4], aw[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = m0 + (tid >> 3) + 32 * j;
    const int rem = r % (hh * ww);
    ar[j] = r;
    ah[j] = r < m ? rem / ww : -4;
    aw[j] = rem % ww;
  }
  const int chunks = (c + kTK - 1) / kTK;
  const int total = 9 * chunks;

  auto prefetch = [&](int i) {
    bf16* as = ring + (i % kRing) * kStage;
    bf16* bs = as + kStageA;
    const int tap = i / chunks;
    const int c0 = (i - tap * chunks) * kTK;
    const int a = tap / 3 - 1;
    const int b = tap % 3 - 1;
    const int ch = c0 + seg * 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = (tid >> 3) + 32 * j;
      const int sh = ah[j] + a;
      const int sw = aw[j] + b;
      const bool in = ch < c && sh >= 0 && sh < hh && sw >= 0 && sw < ww;
      tc::cp_async16(
          as + tc::swz<kTK / 8>(row, seg),
          in ? x + static_cast<size_t>(ar[j] + a * ww + b) * c + ch : x, in);
      const int k = (tid >> 4) + 16 * j;
      const int oc = co0 + (tid & 15) * 8;
      const bool win = c0 + k < c && oc < co;
      tc::cp_async16(
          bs + ((tid >> 3) & 1) * kHalfB + tc::swz<8>(k, tid & 7),
          win ? w9 + (static_cast<size_t>(tap) * c + c0 + k) * co + oc : w9,
          win);
    }
  };

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
  for (int i = 0; i < kRing - 1; ++i) {
    if (i < total) prefetch(i);
    tc::commit();
  }
  const int wg = warp >> 2;   // the warpgroup: rows 64 wg .. 64 wg + 63
  for (int i = 0; i < total; ++i) {
    tc::wait<kRing - 2>();
    tc::fence_proxy_async();   // the landed copies, for wgmma's reads
    __syncthreads();  // stage i landed; stage i - 1's products done
    if (i + kRing - 1 < total) prefetch(i + kRing - 1);
    tc::commit();
    const uint32_t at = tc::smem_u32(ring + (i % kRing) * kStage);
    const uint32_t a0 = at + wg * 64 * kTK * sizeof(bf16);
    const uint32_t b0 = at + kStageA * sizeof(bf16);
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTK / 16; ++ks)
      tc::wgmma_m64n128k16(
          acc, tc::wgmma_desc(a0 + 32 * ks),
          tc::wgmma_desc(b0 + 16 * 128 * ks, kHalfB * sizeof(bf16)), 1);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
  }
  tc::wait<0>();
  __syncthreads();  // the ring is free: the y tile [kTM][kOutPitch]
  bf16* ys = ring;
  const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < kTN / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(ys + (r0 + 8 * h) * kOutPitch +
                                         8 * i + 2 * (lane & 3)) =
          __floats2bfloat162_rn(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kTM * kTN / 8 / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int row = i >> 4;
    const int oc = co0 + (i & 15) * 8;
    if (m0 + row < m && oc < co)
      *reinterpret_cast<uint4*>(y + static_cast<size_t>(m0 + row) * co + oc) =
          *reinterpret_cast<const uint4*>(ys + row * kOutPitch + (i & 15) * 8);
  }
}

// ---- conv3x3_same_f32: 3xTF32 on wgmma (see the note at the head) -------

constexpr int kFK = 32;                 // fp32 channels per K step: 128 bytes
constexpr int kFRing = 4;               // stages of the ring
constexpr int kFPitchA = kFK + 4;       // floats a staged x row
constexpr int kFTileB = kTN * kFK;      // floats of a staged w_big or w_small
constexpr int kFStage = 2 * kFTileB + kTM * kFPitchA;   // floats a stage
constexpr int kFOutPitch = kTN + 8;     // fp32 pitch of the epilogue's y tile
// the ring, its 2 kFRing mbarriers, and room to put it on 1024 bytes
constexpr size_t kFRingBytes =
    sizeof(float) * kFRing * kFStage + 16 * kFRing + 1024;
static_assert(sizeof(float) * kFStage % 1024 == 0,
              "every stage's B tiles start on the swizzle's 1024 bytes");
static_assert(kTM * kFK / 4 == 4 * kThreads && kTN * kFK / 4 == 4 * kThreads,
              "four 16-byte copies of each tile a thread");
static_assert(sizeof(float) * kTM * kFOutPitch <= kFRingBytes - 1024,
              "the y tile fits in the ring");

__host__ __device__ constexpr int f32_cp(int c) {
  return (c + kFK - 1) / kFK * kFK;
}

// w9 [9][C][C_out] -> w_big, w_small [9][C_out][Cp], zeros past C: a
// 32 x 32 transpose through shared memory per block, grid (Cp / 32,
// ceil(C_out / 32), 9), 32 x 8 threads.
__global__ void __launch_bounds__(256)
conv3x3_f32_split_w_kernel(const float* __restrict__ w9,
                           float* __restrict__ wbig,
                           float* __restrict__ wsmall, int c, int co) {
  __shared__ float t[32][33];
  const int cp = f32_cp(c);
  const int tap = blockIdx.z;
  const int c0 = blockIdx.x * 32;
  const int o0 = blockIdx.y * 32;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = threadIdx.y + 8 * j;
    const int ch = c0 + k;
    const int oc = o0 + threadIdx.x;
    t[k][threadIdx.x] =
        ch < c && oc < co ? w9[(static_cast<size_t>(tap) * c + ch) * co + oc]
                          : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = threadIdx.y + 8 * j;
    if (o0 + o >= co) continue;
    const float v = t[threadIdx.x][o];
    const float big = __uint_as_float(tc::tf32_rna(v));
    const size_t at = (static_cast<size_t>(tap) * co + o0 + o) * cp + c0 +
                      threadIdx.x;
    wbig[at] = big;
    wsmall[at] = __uint_as_float(tc::tf32_rna(v - big));
  }
}

__global__ void __launch_bounds__(kThreads, 1)
conv3x3_f32_tc_kernel(const float* __restrict__ x,
                      const float* __restrict__ wbig,
                      const float* __restrict__ wsmall, float* __restrict__ y,
                      int n, int hh, int ww, int c, int co) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  float* ring =
      reinterpret_cast<float*>(smem_raw + (((raw + 1023) & ~1023u) - raw));
  const int m = n * hh * ww;
  const int cp = f32_cp(c);
  const int ntiles = (co + kTN - 1) / kTN;
  const int m0 = (blockIdx.x / ntiles) * kTM;
  const int co0 = (blockIdx.x % ntiles) * kTN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // staging: thread -> 16-byte chunk tid % 8 (4 channels) of rows
  // tid / 8 + 32 j of x (each row's r and (h, w), h = -4 past M) and of the
  // output rows tid / 8 + 32 j of w_big and w_small
  const int seg = tid & 7;
  int ar[4], ah[4], aw[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = m0 + (tid >> 3) + 32 * j;
    const int rem = r % (hh * ww);
    ar[j] = r;
    ah[j] = r < m ? rem / ww : -4;
    aw[j] = rem % ww;
  }
  const int chunks = cp / kFK;
  const int total = 9 * chunks;

  // a stage: w_big tile, w_small tile (each [128][32], swizzled), x tile
  auto prefetch = [&](int i) {
    float* bb = ring + (i % kFRing) * kFStage;
    float* bsm = bb + kFTileB;
    float* as = bsm + kFTileB;
    const int tap = i / chunks;
    const int c0 = (i - tap * chunks) * kFK;
    const int a = tap / 3 - 1;
    const int b = tap % 3 - 1;
    const int ch = c0 + seg * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = (tid >> 3) + 32 * j;
      const int sh = ah[j] + a;
      const int sw = aw[j] + b;
      const bool in = ch < c && sh >= 0 && sh < hh && sw >= 0 && sw < ww;
      tc::cp_async16(
          as + row * kFPitchA + seg * 4,
          in ? x + static_cast<size_t>(ar[j] + a * ww + b) * c + ch : x, in);
      const int oc = co0 + row;
      const bool win = oc < co;
      const size_t at = (static_cast<size_t>(tap) * co + oc) * cp + ch;
      const int sz = row * kFK + ((seg ^ (row & 7)) << 2);
      tc::cp_async16(bb + sz, win ? wbig + at : wbig, win);
      tc::cp_async16(bsm + sz, win ? wsmall + at : wsmall, win);
    }
  };

  float acc[64], part[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    acc[e] = 0.0f;
    part[e] = 0.0f;
  }
  // full[s]: all threads' copies into buffer s landed; empty[s]: the 8
  // warps are done reading it
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kFRing * kFStage);
  uint64_t* empty = full + kFRing;
  if (tid == 0)
    for (int s = 0; s < kFRing; ++s) {
      tc::mbar_init(full + s, kThreads);
      tc::mbar_init(empty + s, kThreads / 32);
    }
  __syncthreads();
  for (int i = 0; i < kFRing - 1 && i < total; ++i) {
    prefetch(i);
    tc::mbar_arrive_cp_async(full + i);
  }
  const int wg = warp >> 2;   // the warpgroup: rows 64 wg .. 64 wg + 63
  // this thread's A fragment rows 64 wg + 16 (warp % 4) + g (+ 8), k q (+ 4)
  const int frag = (wg * 64 + (warp & 3) * 16 + (lane >> 2)) * kFPitchA +
                   (lane & 3);
  for (int i = 0; i < total; ++i) {
    const int buf = i % kFRing;
    tc::mbar_wait(full + buf, (i / kFRing) & 1);
    tc::fence_proxy_async();   // the landed copies, for wgmma's reads
    const float* st = ring + buf * kFStage;
    const float* as = st + 2 * kFTileB + frag;
    uint32_t hi[kFK / 8][4], lo[kFK / 8][4];
#pragma unroll
    for (int ks = 0; ks < kFK / 8; ++ks)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float a = as[(v & 1) * 8 * kFPitchA + ks * 8 + (v >> 1) * 4];
        hi[ks][v] = tc::tf32_rna(a);
        lo[ks][v] = tc::tf32_rna(a - __uint_as_float(hi[ks][v]));
      }
    const uint32_t bb = tc::smem_u32(st);
    const uint32_t bsm = bb + kFTileB * sizeof(float);
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kFK / 8; ++ks) {
      tc::wgmma_m64n128k8_tf32(part, lo[ks], tc::wgmma_desc(bb + 32 * ks),
                               ks > 0);
      tc::wgmma_m64n128k8_tf32(part, hi[ks], tc::wgmma_desc(bsm + 32 * ks),
                               1);
      tc::wgmma_m64n128k8_tf32(part, hi[ks], tc::wgmma_desc(bb + 32 * ks),
                               1);
    }
    tc::wgmma_commit();
    // under the products: the copies of stage i + kFRing - 1, into the
    // buffer both warpgroups have left after stage i - 1
    if (i + kFRing - 1 < total) {
      const int nb = (i + kFRing - 1) % kFRing;
      if (i > 0) tc::mbar_wait(empty + nb, ((i - 1) / kFRing) & 1);
      prefetch(i + kFRing - 1);
      tc::mbar_arrive_cp_async(full + nb);
    }
    tc::wgmma_wait<0>();
    tc::fence_operand(part);
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(empty + buf);
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] += part[e];
  }
  __syncthreads();  // the ring is free: the y tile [kTM][kFOutPitch]
  float* ys = ring;
  const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < kTN / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(ys + (r0 + 8 * h) * kFOutPitch + 8 * i +
                                 2 * (lane & 3)) =
          make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kTM * kTN / 4 / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int row = i >> 5;
    const int oc = co0 + (i & 31) * 4;
    if (m0 + row < m && oc < co)
      *reinterpret_cast<float4*>(y + static_cast<size_t>(m0 + row) * co +
                                 oc) =
          *reinterpret_cast<const float4*>(ys + row * kFOutPitch +
                                           (i & 31) * 4);
  }
}

// ---- the ragged routes (see the note at the head) ----------------------

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// The block's view of one staged row: which image position it is, and
// whether it lies in y at all.
struct RowPos {
  int img, h, w;
  bool valid;
};

__device__ __forceinline__ RowPos row_pos(int r, int m, int hh, int ww) {
  RowPos p;
  p.valid = r < m;
  const int hw = hh * ww;
  p.img = p.valid ? r / hw : 0;
  const int rem = r - p.img * hw;
  p.h = rem / ww;
  p.w = rem - p.h * ww;
  return p;
}

// Stage 8 channels [c0 + k8, c0 + k8 + 8) of the source row of `pos` for tap
// (a, b) into dst[0..7] (stride `stride` between channels); zero outside the
// image and past C.
template <typename T>
__device__ __forceinline__ void stage_x(T* dst, int stride, const T* x,
                                        const RowPos& pos, int a, int b,
                                        int c0, int k8, int hh, int ww,
                                        int c) {
  const int sh = pos.h + a;
  const int sw = pos.w + b;
  const bool in =
      pos.valid && sh >= 0 && sh < hh && sw >= 0 && sw < ww;
  const T* src =
      x + ((static_cast<size_t>(pos.img) * hh + (in ? sh : 0)) * ww +
           (in ? sw : 0)) * c;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ch = c0 + k8 + j;
    dst[j * stride] = in && ch < c ? src[ch] : from_float<T>(0.0f);
  }
}

// Stage 8 output channels [co0 + n8, co0 + n8 + 8) of weight row
// (tap, c0 + k) into dst[0..7]; zero past C and C_out.
template <typename T>
__device__ __forceinline__ void stage_w(T* dst, const T* w9, int tap, int c0,
                                        int k, int co0, int n8, int c,
                                        int co) {
  const int ch = c0 + k;
  const T* src = w9 + (static_cast<size_t>(tap) * c + ch) * co;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int oc = co0 + n8 + j;
    dst[j] = ch < c && oc < co ? src[oc] : from_float<T>(0.0f);
  }
}

__global__ void __launch_bounds__(kThreads)
conv3x3_bf16_ragged_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ w9, bf16* __restrict__ y,
                           int n, int hh, int ww, int c, int co) {
  __shared__ __align__(128) bf16 as[kBM][kBK + kPadA];   // rows x channels
  __shared__ __align__(128) bf16 bs[kBK][kBN + kPadA];   // channels x outs
  __shared__ __align__(128) float cs[kBM][kBN + 4];      // the fp32 tile

  const int m = n * hh * ww;
  const int m0 = blockIdx.x * kBM;
  const int co0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  // staging: thread -> (row tid / 4, channels 8 (tid % 4)..) of x and
  // (channel tid / 8, outputs 8 (tid % 8)..) of the weight
  const int arow = tid >> 2;
  const int ak8 = (tid & 3) * 8;
  const int bk = tid >> 3;
  const int bn8 = (tid & 7) * 8;
  const RowPos pos = row_pos(m0 + arow, m, hh, ww);
  // compute: warp -> rows 16 (warp % 4).., outputs 32 (warp / 4)..
  const int wr = (warp & 3) * 16;
  const int wc = (warp >> 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);

  for (int tap = 0; tap < 9; ++tap) {
    const int a = tap / 3 - 1;
    const int b = tap % 3 - 1;
    for (int c0 = 0; c0 < c; c0 += kBK) {
      __syncthreads();  // previous readers of as / bs done
      stage_x(&as[arow][ak8], 1, x, pos, a, b, c0, ak8, hh, ww, c);
      stage_w(&bs[bk][bn8], w9, tap, c0, bk, co0, bn8, c, co);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, &as[wr][kk], kBK + kPadA);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, &bs[kk][wc + 16 * j], kBN + kPadA);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(&cs[wr][wc + 16 * j], acc[j], kBN + 4,
                            wmma::mem_row_major);
  __syncthreads();
  // out: thread -> row tid / 4, outputs 16 (tid % 4)..
  const int orow = m0 + (tid >> 2);
  const int on = (tid & 3) * 16;
  if (orow < m)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int oc = co0 + on + j;
      if (oc < co)
        y[static_cast<size_t>(orow) * co + oc] =
            __float2bfloat16_rn(cs[tid >> 2][on + j]);
    }
}

__global__ void __launch_bounds__(kThreads)
conv3x3_f32_ragged_kernel(const float* __restrict__ x, const float* __restrict__ w9,
                   float* __restrict__ y, int n, int hh, int ww, int c,
                   int co) {
  __shared__ float as[kBK][kBM];  // channels x rows (transposed)
  __shared__ float bs[kBK][kBN];  // channels x outs

  const int m = n * hh * ww;
  const int m0 = blockIdx.x * kBM;
  const int co0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int arow = tid >> 2;
  const int ak8 = (tid & 3) * 8;
  const int bk = tid >> 3;
  const int bn8 = (tid & 7) * 8;
  const RowPos pos = row_pos(m0 + arow, m, hh, ww);
  // compute: thread -> rows 4 (tid / 16).., outputs 4 (tid % 16)..
  const int tr = (tid >> 4) * 4;
  const int tc = (tid & 15) * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int tap = 0; tap < 9; ++tap) {
    const int a = tap / 3 - 1;
    const int b = tap % 3 - 1;
    for (int c0 = 0; c0 < c; c0 += kBK) {
      __syncthreads();
      stage_x(&as[ak8][arow], kBM, x, pos, a, b, c0, ak8, hh, ww, c);
      stage_w(&bs[bk][bn8], w9, tap, c0, bk, co0, bn8, c, co);
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[i] = as[k][tr + i];
          bv[i] = bs[k][tc + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + tr + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int oc = co0 + tc + j;
      if (oc < co) y[static_cast<size_t>(row) * co + oc] = acc[i][j];
    }
  }
}

template <typename T, typename K>
int launch(K kernel, const T* x, const T* w9, T* y, int n, int hh, int ww,
           int c, int co, void* stream) {
  const long long m = static_cast<long long>(n) * hh * ww;
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM),
                  static_cast<unsigned>((co + kBN - 1) / kBN));
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w9, y, n, hh, ww, c, co);
  return static_cast<int>(cudaGetLastError());
}

// One block per 128 x 128 tile of y, the output-channel tiles of a row tile
// next to each other in launch order, so that they read its x rows from L2
// at about the same time.
int launch_bf16(const bf16* x, const bf16* w9, bf16* y, int n, int hh, int ww,
                int c, int co, void* stream) {
  if (c % 8 || co % 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kRingBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long m = static_cast<long long>(n) * hh * ww;
  const long long blocks = (m + kTM - 1) / kTM * ((co + kTN - 1) / kTN);
  conv3x3_bf16_kernel<<<static_cast<unsigned>(blocks), kThreads, kRingBytes,
                        static_cast<cudaStream_t>(stream)>>>(x, w9, y, n, hh,
                                                             ww, c, co);
  return static_cast<int>(cudaGetLastError());
}

// The pre-pass into the workspace, then one block per 128 x 128 tile of y
// as for bf16.
int launch_f32(const float* x, const float* w9, float* y, int n, int hh,
               int ww, int c, int co, float* work, void* stream) {
  if (c % 4 || co % 4) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cp = f32_cp(c);
  float* wbig = work;
  float* wsmall = work + static_cast<size_t>(9) * co * cp;
  conv3x3_f32_split_w_kernel<<<dim3(cp / 32, (co + 31) / 32, 9), dim3(32, 8),
                               0, s>>>(w9, wbig, wsmall, c, co);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(conv3x3_f32_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kFRingBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long m = static_cast<long long>(n) * hh * ww;
  const long long blocks = (m + kTM - 1) / kTM * ((co + kTN - 1) / kTN);
  conv3x3_f32_tc_kernel<<<static_cast<unsigned>(blocks), kThreads,
                          kFRingBytes, s>>>(x, wbig, wsmall, y, n, hh, ww, c,
                                            co);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int conv3x3_same_bf16(const void* x, const void* w9, void* y, int n, int h,
                      int w, int c, int co, void* stream) {
  return launch_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(w9),
                     static_cast<bf16*>(y), n, h, w, c, co, stream);
}

int conv3x3_same_bf16_ragged(const void* x, const void* w9, void* y, int n,
                             int h, int w, int c, int co, void* stream) {
  return launch(conv3x3_bf16_ragged_kernel, static_cast<const bf16*>(x),
                static_cast<const bf16*>(w9), static_cast<bf16*>(y), n, h, w,
                c, co, stream);
}

// fp32 values of the workspace conv3x3_same_f32 needs: w_big and w_small,
// each [9][C_out][Cp].
long long conv3x3_f32_workspace(int c, int co) {
  return 2LL * 9 * co * f32_cp(c);
}

int conv3x3_same_f32(const void* x, const void* w9, void* y, int n, int h,
                     int w, int c, int co, void* work, void* stream) {
  return launch_f32(static_cast<const float*>(x),
                    static_cast<const float*>(w9), static_cast<float*>(y), n,
                    h, w, c, co, static_cast<float*>(work), stream);
}

int conv3x3_same_f32_ragged(const void* x, const void* w9, void* y, int n,
                            int h, int w, int c, int co, void* stream) {
  return launch(conv3x3_f32_ragged_kernel, static_cast<const float*>(x),
                static_cast<const float*>(w9), static_cast<float*>(y), n, h,
                w, c, co, stream);
}

}  // extern "C"
