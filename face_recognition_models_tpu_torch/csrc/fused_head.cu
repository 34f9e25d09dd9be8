// Fused margin + cross-entropy head for Hopper (sm_90a): IEEE fp32, and
// bf16 products on the tensor cores (the _bf16 entries).
//
// Counterparts of the Pallas kernels in face_recognition_models_tpu/ops/
// fused_head.py:
//   fused_ce_fwd     <- _fwd_kernel        (K1)
//   fused_ce_bwd_dx  <- _bwd_fused_kernel's dx/dt/dscale half (K2), and
//                       _bwd_dx_kernel (K3a)
//   fused_ce_bwd_dw  <- _bwd_fused_kernel's dw half (K2), and
//                       _bwd_dw_kernel (K3b)
// and the has_mem=True bodies of the same kernels (K4), reached through
// fused_margin_ce_mem (:727):
//   fused_ce_fwd_mem    <- _fwd_kernel's blend (:122-126)
//   fused_ce_bwd_dx_mem <- the dx half of _bwd_fused_kernel (:395-400) and
//                          _bwd_dx_kernel (:236-240)
//   fused_ce_bwd_dw_mem <- the dw half of _bwd_fused_kernel (:401-402) and
//                          _bwd_dw_kernel (:305-307)
//
// Every head reduces to
//   logit[i, j]        = scale[i] * h(cos[i, j], a[i], b[i])   (j != label[i])
//   logit[i, label[i]] = scale[i] * t[i]
// with cos = xn @ wn, h one of three modes (identity, MV, curricular) and an
// optional clamp of cos to [-1 + eps, 1 - eps]. Columns >= C are masked and a
// label outside [0, C) marks no column as target (the class-sharded caller
// relies on that). The [N, C] logits never reach device memory.
//
// Memory-blended heads (VPL-ArcFace, QAFace; the kMem instantiations) blend
// every column with a per-class memory before the clamp:
//   cos[i, j] = (1 - lam[j]) * (xn @ wn)[i, j] + lam[j] * (xn @ memn)[i, j]
// memn [D, C] and lam [C] are constants of the step (no gradient). dx flows
// through both products, dw only through the (1 - lam) share; a column with
// lam = 1 gets no dw and all of its dx through memn.
//
// What bounds them: at the training shape (N=512, D=512, C=10,575) one
// product P = 2*N*D*C is 5.5 GFLOP (0.083 ms at 67 TFLOP/s fp32 outside the
// tensor cores) against ~22 MB of wn (0.007 ms at 3.35 TB/s), so each kernel
// is bound by fp32 operations, not by bytes. fwd needs P, bwd_dx and bwd_dw
// 2P each (cos again, then their own product). With the blend each product
// runs over wn and over memn: fwd_mem 2P (0.166 ms), bwd_dx_mem 4P
// (0.331 ms), bwd_dw_mem 3P (0.248 ms), against 43 MB of wn + memn. The
// kernels do this dense work; a column with lam = 0 needs no memory product
// and one with lam = 1 no weight product, so with VPL's few active classes
// the work the data needs is close to the unblended kernels' (chip_smoke.py
// counts it so). The products run in IEEE fp32 on the CUDA cores, never
// TF32: the acos-based margins downstream need full fp32 cosines, as the JAX
// package runs this math at Precision.HIGHEST.
//
// Design. On the TPU the class axis is a sequential grid axis and per-row
// state (running max, sum, rank count; the dx accumulator) sits in VMEM
// across it. Here blocks run in parallel and in no order, so:
//   - fwd and bwd_dx give each block a tile of kRows rows and loop over class
//     tiles inside the block; per-row state lives in registers;
//   - the backward is two launches instead of K2's single sweep: bwd_dx
//     reduces over C (row tiles), bwd_dw reduces over N (class tiles). A
//     one-launch backward would need atomics for dx or dw, whose summation
//     order changes from run to run. The price is a fourth product: cos is
//     recomputed in both backward kernels.
// Each product is a register-tiled SIMT loop over chunks of W staged in
// shared memory. This is the simple, right form; tensor-core (3xTF32 or
// split-bf16) variants and splitting C across blocks at small N are later
// work. The memory blend is a compile-time switch (template <bool kMem>) on
// the kernel bodies: the kMem = false instantiations are the ArcFace kernels
// unchanged (same code, registers and launch bounds), and kMem = true stages
// memn beside wn in the same loops.
//
// Shared memory per block at D = 512 (the limit is 232,448 B):
//   fwd 49,280 B; fwd_mem 65,792 B (a second [kChunk][kCols + 1] chunk);
//   bwd_dx 90,240 B; bwd_dx_mem 114,944 B (a memn chunk and a dcos * lam
//   tile beside the dcos * (1 - lam) one);
//   bwd_dw 165,888 B; bwd_dw_mem 231,424 B: the memn tile [512][32] stays
//   resident beside the wn tile (65,536 B more) and lam of the lane's column
//   sits in a register, leaving 1,024 B. A width above 512 is refused by
//   the wrapper (fused_ce_smem_bytes).
//   The bf16 kernels (layouts at BfLayout and DwLayout): fwd 59,904 B,
//   fwd_mem 103,168 B, bwd_dx 97,280 B, bwd_dx_mem 144,896 B, bwd_dw
//   141,824 B, bwd_dw_mem 192,000 B; the widest D they take is 624
//   (bwd_dw_mem).
//
// bf16 products (K5: the mm_dtype=jnp.bfloat16 option of every kernel above,
// fused_head.py:119-126, 192-196, 237-243, 269-276, 307, 352-360, 396-407):
//   fused_ce_{fwd,bwd_dx,bwd_dw}_bf16 and fused_ce_{fwd,bwd_dx,bwd_dw}_mem_bf16
// are the same bodies with a second template parameter (kBf16) that changes
// only the products; the epilogues (margin, clamp, online logsumexp,
// `higher`, dcos) are shared and the fp32 instantiations compile as before.
// The operands stay fp32 in device memory, as in JAX, and are rounded to
// bf16 (__float2bfloat16_rn, round to nearest even) as they are staged in
// shared memory, at exactly the six places of the Pallas kernels: xn and wn
// before every cosine product, memn, dcos before the dx and dw products, and
// with the blend dcos * (1 - lam) and dcos * lam, each rounded on its own.
// Every product runs on the tensor cores as nvcuda::wmma 16x16x16 bf16
// fragments with fp32 accumulators: in fwd and bwd_dx warp w computes the
// 16 x 16 cosine block of columns 16w..16w+15 of the 128-wide class tile over
// 128-deep chunks of W, stores it into an fp32 [kRows][kCols] tile in shared
// memory, and the fp32 epilogue reads that tile in its SIMT mapping (two
// rows per warp, four columns per lane); bwd_dx then adds
// bf16(dcos) [16 x 128] . bf16(wn)^T [128 x 16] into an fp32 dx tile in shared
// memory, warp w owning 16 columns of each 128-deep chunk of D. bwd_dw
// splits the 16 x 32 cosine block's depth over four warps per 16 columns
// (partial sums added in the epilogue) and adds bf16(xn)^T . bf16(dcos) into
// an fp32 [D][32] tile. D is padded with zeros to a multiple of 16 in shared
// memory. What bounds them at N=512, D=512, C=10,575: one product is
// 5.5 GFLOP, 5.6 us at 989 TFLOP/s dense bf16, against 21.7 MB of fp32 wn
// (6.5 us at 3.35 TB/s): the forward is bound by bytes, the backward kernels
// (two or three products) lie close to the line. These kernels stage every
// operand through shared memory with synchronous loads and multiply with
// wmma (no wgmma or TMA yet), on the fp32 kernels' grids (32 blocks for fwd
// and bwd_dx at N=512), so they reach neither bound.
//
// C interface: each entry launches on the given stream and returns
// cudaGetLastError() (0 on success). All pointers are device pointers to
// contiguous fp32 (labels int32) arrays; ab is [N, 2] with a = ab[:, 0],
// b = ab[:, 1]; wn, memn and dw are [D, C] row-major, lam is [C].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // 8 warps; warp w owns rows 2w and 2w + 1
constexpr int kRows = 16;       // rows per block tile
constexpr int kCols = 128;      // class-tile width of fwd / bwd_dx (4 per lane)
constexpr int kChunk = 32;      // depth of one W chunk staged in shared memory
constexpr int kDwCols = 32;     // class-tile width of bwd_dw (1 per lane)
constexpr float kNegInf = -1e30f;
// bf16 (tensor-core) kernels
constexpr int kChunkB = 128;        // depth of one bf16 W chunk (8 k-steps)
constexpr int kLdB = kCols + 8;     // pitch of bf16 [.][kCols] tiles
constexpr int kLdC = kCols + 4;     // pitch of the fp32 cos tile
constexpr int kLdWb = kDwCols + 8;  // pitch of bwd_dw's bf16 [.][kDwCols] tiles
constexpr int kLdP = kDwCols + 4;   // pitch of bwd_dw's fp32 [.][kDwCols] tiles
constexpr int kSplitK = 4;          // bwd_dw warps sharing one cos block

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kModeMV = 1;
constexpr int kModeCurricular = 2;

__device__ __forceinline__ float h_fn(int mode, float cos, float a, float b) {
  if (mode == kModeMV) return cos > a ? b * cos + (b - 1.0f) : cos;
  if (mode == kModeCurricular) return cos > a ? cos * (b + cos) : cos;
  return cos;
}

__device__ __forceinline__ float h_grad(int mode, float cos, float a, float b) {
  if (mode == kModeMV) return cos > a ? b : 1.0f;
  if (mode == kModeCurricular) return cos > a ? b + 2.0f * cos : 1.0f;
  return 1.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Per-row scalars. Rows past N get values that make them inert: no target
// column, zero upstream gradient.
struct Row {
  int label;
  float t, tcos, scale, a, b, lse, g_lse, g_t;
};

__device__ __forceinline__ Row load_row(int row, int n, const int* labels,
                                        const float* t, const float* tcos,
                                        const float* scale, const float* ab,
                                        const float* lse, const float* g_lse,
                                        const float* g_t) {
  Row r;
  if (row < n) {
    r.label = labels[row];
    r.t = t[row];
    r.tcos = tcos ? tcos[row] : 0.0f;
    r.scale = scale[row];
    r.a = ab[2 * row];
    r.b = ab[2 * row + 1];
    r.lse = lse ? lse[row] : 0.0f;
    r.g_lse = g_lse ? g_lse[row] : 0.0f;
    r.g_t = g_t ? g_t[row] : 0.0f;
  } else {
    r.label = -1;
    r.t = 0.0f;
    r.tcos = 2.0f;
    r.scale = 1.0f;
    r.a = 2.0f;
    r.b = 1.0f;
    r.lse = 0.0f;
    r.g_lse = 0.0f;
    r.g_t = 0.0f;
  }
  return r;
}

// Stage rows [row0, row0 + kRows) of xn [N, D] into xs [kRows][D].
__device__ __forceinline__ void load_rows(float* xs, const float* xn, int row0,
                                          int n, int d) {
  for (int i = threadIdx.x; i < kRows * d; i += kThreads) {
    const int r = i / d;
    const int row = row0 + r;
    xs[i] = row < n ? xn[static_cast<size_t>(row) * d + (i - r * d)] : 0.0f;
  }
}

// Stage wn[d0:d0+kChunk, c0:c0+kCols] into ws [kChunk][kCols + 1] (padded so
// that a lane walking one chunk row per lane hits distinct banks), zero past
// D and C.
__device__ __forceinline__ void load_chunk(float* ws, const float* wn, int d0,
                                           int c0, int d, int c) {
  for (int i = threadIdx.x; i < kChunk * kCols; i += kThreads) {
    const int k = i / kCols;
    const int j = i - k * kCols;
    const int dd = d0 + k;
    const int col = c0 + j;
    ws[k * (kCols + 1) + j] =
        (dd < d && col < c) ? wn[static_cast<size_t>(dd) * c + col] : 0.0f;
  }
}

// lam of the lane's four columns (lane + 32 * i) of the tile at c0; 0 past C.
__device__ __forceinline__ void load_lam(float lt[4], const float* lam, int c0,
                                         int c) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = c0 + lane + 32 * i;
    lt[i] = col < c ? lam[col] : 0.0f;
  }
}

// cos for the warp's two rows x the lane's four columns (lane + 32 * i) of
// the class tile starting at c0. With kMem, the blended cosine
// (1 - lt) * (x . wn) + lt * (x . memn), memn staged through `ms` as wn is
// through `ws`.
template <bool kMem>
__device__ __forceinline__ void cos_tile(float acc[2][4], const float* xs,
                                         float* ws, float* ms, const float* wn,
                                         const float* memn, const float lt[4],
                                         int c0, int d, int c, int r0) {
  const int lane = threadIdx.x & 31;
  float accm[2][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[q][i] = accm[q][i] = 0.0f;
  for (int d0 = 0; d0 < d; d0 += kChunk) {
    __syncthreads();
    load_chunk(ws, wn, d0, c0, d, c);
    if constexpr (kMem) load_chunk(ms, memn, d0, c0, d, c);
    __syncthreads();
    const int kmax = min(kChunk, d - d0);
    for (int k = 0; k < kmax; ++k) {
      const float x0 = xs[r0 * d + d0 + k];
      const float x1 = xs[(r0 + 1) * d + d0 + k];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = ws[k * (kCols + 1) + lane + 32 * i];
        acc[0][i] = fmaf(x0, w, acc[0][i]);
        acc[1][i] = fmaf(x1, w, acc[1][i]);
        if constexpr (kMem) {
          const float mv = ms[k * (kCols + 1) + lane + 32 * i];
          accm[0][i] = fmaf(x0, mv, accm[0][i]);
          accm[1][i] = fmaf(x1, mv, accm[1][i]);
        }
      }
    }
  }
  if constexpr (kMem) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[q][i] = (1.0f - lt[i]) * acc[q][i] + lt[i] * accm[q][i];
  }
}

// ---- bf16 tiles --------------------------------------------------------

__host__ __device__ constexpr int round16(int d) { return (d + 15) & ~15; }
__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) & ~static_cast<size_t>(127);
}

// Byte offsets of the bf16 fwd / bwd_dx buffers in dynamic shared memory,
// each 128-byte aligned (wmma tiles must start on 32 bytes). dp = D padded
// to a multiple of 16:
//   xb  [kRows][dp + 8] bf16   the block's rows of xn
//   wb  [kChunkB][kLdB] bf16   a chunk of wn (mb: of memn, kMem)
//   ct  [kRows][kLdC]   fp32   the cosine tile (cm: the memory's, kMem)
//   dx  [kRows][dp + 4] fp32   bwd_dx's accumulator
//   dcb [kRows][kLdB]   bf16   bf16(dcos (* (1 - lam))) (dcm: bf16(dcos * lam))
struct BfLayout {
  size_t xb, wb, mb, ct, cm, dx, dcb, dcm, total;
};

__host__ __device__ inline BfLayout bf_layout(int d, bool mem, bool with_dx) {
  const int dp = round16(d);
  const size_t wchunk = align128(sizeof(bf16) * kChunkB * kLdB);
  const size_t ctile = align128(sizeof(float) * kRows * kLdC);
  const size_t dtile = align128(sizeof(bf16) * kRows * kLdB);
  BfLayout L;
  size_t o = 0;
  L.xb = o;
  o += align128(sizeof(bf16) * kRows * (dp + 8));
  L.wb = o;
  o += wchunk;
  L.mb = o;
  o += mem ? wchunk : 0;
  L.ct = o;
  o += ctile;
  L.cm = o;
  o += mem ? ctile : 0;
  L.dx = o;
  o += with_dx ? align128(sizeof(float) * kRows * (dp + 4)) : 0;
  L.dcb = o;
  o += with_dx ? dtile : 0;
  L.dcm = o;
  o += with_dx && mem ? dtile : 0;
  L.total = o;
  return L;
}

struct BfTiles {
  bf16 *xb, *wb, *mb, *dcb, *dcm;
  float *ct, *cm, *dx;
  int dp;
};

__device__ __forceinline__ BfTiles bf_tiles(float* smem, int d, bool mem,
                                            bool with_dx) {
  char* base = reinterpret_cast<char*>(smem);
  const BfLayout L = bf_layout(d, mem, with_dx);
  BfTiles s;
  s.xb = reinterpret_cast<bf16*>(base + L.xb);
  s.wb = reinterpret_cast<bf16*>(base + L.wb);
  s.mb = reinterpret_cast<bf16*>(base + L.mb);
  s.ct = reinterpret_cast<float*>(base + L.ct);
  s.cm = reinterpret_cast<float*>(base + L.cm);
  s.dx = reinterpret_cast<float*>(base + L.dx);
  s.dcb = reinterpret_cast<bf16*>(base + L.dcb);
  s.dcm = reinterpret_cast<bf16*>(base + L.dcm);
  s.dp = round16(d);
  return s;
}

// Rows [row0, row0 + kRows) of xn [N, D] into xb [kRows][dp + 8], rounded to
// bf16; zero past N and D.
__device__ __forceinline__ void load_rows_bf16(bf16* xb, const float* xn,
                                               int row0, int n, int d,
                                               int dp) {
  for (int i = threadIdx.x; i < kRows * dp; i += kThreads) {
    const int r = i / dp;
    const int k = i - r * dp;
    const int row = row0 + r;
    xb[r * (dp + 8) + k] = __float2bfloat16_rn(
        row < n && k < d ? xn[static_cast<size_t>(row) * d + k] : 0.0f);
  }
}

// wn[d0:d0+kChunkB, c0:c0+kCols] into wb [kChunkB][kLdB], rounded to bf16;
// zero past D and C.
__device__ __forceinline__ void load_chunk_bf16(bf16* wb, const float* wn,
                                                int d0, int c0, int d, int c) {
#pragma unroll 16
  for (int it = 0; it < kChunkB * kCols / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int k = i / kCols;
    const int j = i - k * kCols;
    const int dd = d0 + k;
    const int col = c0 + j;
    wb[k * kLdB + j] = __float2bfloat16_rn(
        (dd < d && col < c) ? wn[static_cast<size_t>(dd) * c + col] : 0.0f);
  }
}

// cos_tile on the tensor cores: the same acc[2][4] (the warp's two rows x the
// lane's four columns of the class tile at c0), from bf16 operands with fp32
// accumulation. Warp w computes the 16 x 16 block of columns 16w.. through
// wmma, the blocks meet in the fp32 tile ct, and each thread reads its own
// elements back. With kMem the blend runs on the fp32 values, as in fp32.
template <bool kMem>
__device__ __forceinline__ void cos_tile_bf16(float acc[2][4],
                                              const BfTiles& s,
                                              const float* wn,
                                              const float* memn,
                                              const float lt[4], int c0,
                                              int d, int c, int r0) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  FragC fc, fm;
  wmma::fill_fragment(fc, 0.0f);
  if constexpr (kMem) wmma::fill_fragment(fm, 0.0f);
  for (int d0 = 0; d0 < s.dp; d0 += kChunkB) {
    __syncthreads();  // previous readers of wb / ct done
    load_chunk_bf16(s.wb, wn, d0, c0, d, c);
    if constexpr (kMem) load_chunk_bf16(s.mb, memn, d0, c0, d, c);
    __syncthreads();
    const int ksteps = min(kChunkB, s.dp - d0) / 16;
    for (int ks = 0; ks < ksteps; ++ks) {
      FragA a;
      FragB b;
      wmma::load_matrix_sync(a, s.xb + d0 + ks * 16, s.dp + 8);
      wmma::load_matrix_sync(b, s.wb + ks * 16 * kLdB + warp * 16, kLdB);
      wmma::mma_sync(fc, a, b, fc);
      if constexpr (kMem) {
        wmma::load_matrix_sync(b, s.mb + ks * 16 * kLdB + warp * 16, kLdB);
        wmma::mma_sync(fm, a, b, fm);
      }
    }
  }
  wmma::store_matrix_sync(s.ct + warp * 16, fc, kLdC, wmma::mem_row_major);
  if constexpr (kMem)
    wmma::store_matrix_sync(s.cm + warp * 16, fm, kLdC, wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int at = (r0 + q) * kLdC + lane + 32 * i;
      acc[q][i] = s.ct[at];
      if constexpr (kMem)
        acc[q][i] = (1.0f - lt[i]) * acc[q][i] + lt[i] * s.cm[at];
    }
}

// dx[rows, :] += bf16(dcos) . bf16(wn)[:, tile]^T (+ bf16(dcos * lam) .
// bf16(memn)[:, tile]^T) into the fp32 tile s.dx. Warp w owns the 16 columns
// d0 + 16w of each kChunkB-deep chunk of D.
template <bool kMem>
__device__ __forceinline__ void dx_tile_bf16(const BfTiles& s,
                                             const float* wn,
                                             const float* memn, int c0, int d,
                                             int c) {
  const int warp = threadIdx.x >> 5;
  for (int d0 = 0; d0 < s.dp; d0 += kChunkB) {
    __syncthreads();  // dcb written; previous readers of wb done
    load_chunk_bf16(s.wb, wn, d0, c0, d, c);
    if constexpr (kMem) load_chunk_bf16(s.mb, memn, d0, c0, d, c);
    __syncthreads();
    const int col = d0 + warp * 16;
    if (col < s.dp) {
      FragC f;
      wmma::load_matrix_sync(f, s.dx + col, s.dp + 4, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        FragA a;
        FragBt b;
        wmma::load_matrix_sync(a, s.dcb + kk * 16, kLdB);
        wmma::load_matrix_sync(b, s.wb + warp * 16 * kLdB + kk * 16, kLdB);
        wmma::mma_sync(f, a, b, f);
        if constexpr (kMem) {
          wmma::load_matrix_sync(a, s.dcm + kk * 16, kLdB);
          wmma::load_matrix_sync(b, s.mb + warp * 16 * kLdB + kk * 16, kLdB);
          wmma::mma_sync(f, a, b, f);
        }
      }
      wmma::store_matrix_sync(s.dx + col, f, s.dp + 4, wmma::mem_row_major);
    }
  }
}

#define FWD_PARAMS                                                        \
  const float *__restrict__ xn, const float *__restrict__ wn,             \
      const float *__restrict__ memn, const float *__restrict__ lam,      \
      const int *__restrict__ labels, const float *__restrict__ t,        \
      const float *__restrict__ tcos, const float *__restrict__ scale,    \
      const float *__restrict__ ab, float *__restrict__ lse_out,          \
      float *__restrict__ tlogit_out, float *__restrict__ higher_out,     \
      int n, int d, int c, int mode, int has_clamp, float clamp_eps
#define FWD_ARGS                                                          \
  xn, wn, memn, lam, labels, t, tcos, scale, ab, lse_out, tlogit_out,     \
      higher_out, n, d, c, mode, has_clamp, clamp_eps

template <bool kMem, bool kBf16>
__device__ __forceinline__ void fwd_body(FWD_PARAMS) {
  extern __shared__ float smem[];
  float* xs = smem;                    // [kRows][d]
  float* ws = xs + kRows * d;          // [kChunk][kCols + 1]
  float* ms = ws + kChunk * (kCols + 1);  // kMem: [kChunk][kCols + 1]
  BfTiles bt;                          // kBf16: the bf16 layout instead
  if constexpr (kBf16) bt = bf_tiles(smem, d, kMem, false);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;
  const int r0 = 2 * warp;

  Row rp[2];
#pragma unroll
  for (int q = 0; q < 2; ++q)
    rp[q] = load_row(row0 + r0 + q, n, labels, t, tcos, scale, ab, nullptr,
                     nullptr, nullptr);
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  float hi[2] = {0.0f, 0.0f};

  if constexpr (kBf16) load_rows_bf16(bt.xb, xn, row0, n, d, bt.dp);
  else load_rows(xs, xn, row0, n, d);
  for (int c0 = 0; c0 < c; c0 += kCols) {
    float lt[4];
    if constexpr (kMem) load_lam(lt, lam, c0, c);
    float acc[2][4];
    if constexpr (kBf16)
      cos_tile_bf16<kMem>(acc, bt, wn, memn, lt, c0, d, c, r0);
    else
      cos_tile<kMem>(acc, xs, ws, ms, wn, memn, lt, c0, d, c, r0);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float logit[4];
      float tile_max = kNegInf;
      float cnt = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = c0 + lane + 32 * i;
        float cs = acc[q][i];
        if (has_clamp) cs = fminf(fmaxf(cs, -1.0f + clamp_eps), 1.0f - clamp_eps);
        const bool in_range = col < c;
        const bool is_target = col == rp[q].label;
        logit[i] = in_range
                       ? rp[q].scale * (is_target ? rp[q].t
                                                  : h_fn(mode, cs, rp[q].a, rp[q].b))
                       : kNegInf;
        // pre-margin rank statistic for top-k accuracy (on the blended,
        // clamped cos): the target column never counts itself
        if (in_range && !is_target && cs > rp[q].tcos) cnt += 1.0f;
        tile_max = fmaxf(tile_max, logit[i]);
      }
      const float m_new = fmaxf(m[q], warp_max(tile_max));
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c0 + lane + 32 * i < c) s += expf(logit[i] - m_new);
      l[q] = l[q] * expf(m[q] - m_new) + warp_sum(s);
      m[q] = m_new;
      hi[q] += warp_sum(cnt);
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int row = row0 + r0 + q;
      if (row < n) {
        lse_out[row] = m[q] + logf(l[q]);
        tlogit_out[row] = rp[q].scale * rp[q].t;
        higher_out[row] = hi[q];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_ce_fwd_kernel(FWD_PARAMS) { fwd_body<false, false>(FWD_ARGS); }

// The blend's second accumulators do not fit the 64 registers ptxas allots
// a 256-thread block by default (it spilled); allowing one block per SM lets
// it keep them in registers. At N = 512 there are 32 blocks for 132 SMs, so
// the occupancy given up is not used anyway.
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_fwd_mem_kernel(FWD_PARAMS) { fwd_body<true, false>(FWD_ARGS); }

// The bf16 kernels hold wmma fragments beside the epilogue's state; one
// block per SM, as for the _mem kernels.
template <bool kMem>
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_fwd_bf16_kernel(FWD_PARAMS) { fwd_body<kMem, true>(FWD_ARGS); }

// dlogit-side epilogue shared by both backward kernels. Returns dcos and
// adds the row's target / scale gradient terms to dt, dsc.
__device__ __forceinline__ float dcos_of(float cos_raw, int col, int c,
                                         const Row& r, int mode, int has_clamp,
                                         float clamp_eps, float* dt,
                                         float* dsc) {
  if (col >= c) return 0.0f;
  float cs = cos_raw;
  float pass = 1.0f;
  if (has_clamp) {
    cs = fminf(fmaxf(cos_raw, -1.0f + clamp_eps), 1.0f - clamp_eps);
    pass = (cos_raw >= -1.0f + clamp_eps && cos_raw <= 1.0f - clamp_eps)
               ? 1.0f : 0.0f;
  }
  const bool is_target = col == r.label;
  const float hv = h_fn(mode, cs, r.a, r.b);
  const float logit = r.scale * (is_target ? r.t : hv);
  const float dl = r.g_lse * expf(logit - r.lse);
  if (is_target) {
    *dt += dl * r.scale;
    *dsc += dl * r.t;
    return 0.0f;
  }
  *dsc += dl * hv;
  return dl * r.scale * h_grad(mode, cs, r.a, r.b) * pass;
}

#define DX_PARAMS                                                         \
  const float *__restrict__ xn, const float *__restrict__ wn,             \
      const float *__restrict__ memn, const float *__restrict__ lam,      \
      const int *__restrict__ labels, const float *__restrict__ t,        \
      const float *__restrict__ scale, const float *__restrict__ ab,      \
      const float *__restrict__ lse, const float *__restrict__ g_lse,     \
      const float *__restrict__ g_t, float *__restrict__ dx,              \
      float *__restrict__ dt_out, float *__restrict__ dscale_out, int n,  \
      int d, int c, int mode, int has_clamp, float clamp_eps
#define DX_ARGS                                                           \
  xn, wn, memn, lam, labels, t, scale, ab, lse, g_lse, g_t, dx, dt_out,   \
      dscale_out, n, d, c, mode, has_clamp, clamp_eps

template <bool kMem, bool kBf16>
__device__ __forceinline__ void bwd_dx_body(DX_PARAMS) {
  extern __shared__ float smem[];
  float* xs = smem;                        // [kRows][d]
  float* dxs = xs + kRows * d;             // [kRows][d] dx accumulator
  float* ws = dxs + kRows * d;             // [kChunk][kCols + 1]
  float* dcs = ws + kChunk * (kCols + 1);  // [kRows][kCols] dcos (* (1 - lam))
  float* ms = dcs + kRows * kCols;         // kMem: [kChunk][kCols + 1]
  float* dcm = ms + kChunk * (kCols + 1);  // kMem: [kRows][kCols] dcos * lam
  BfTiles bt;                              // kBf16: the bf16 layout instead
  if constexpr (kBf16) bt = bf_tiles(smem, d, kMem, true);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;
  const int r0 = 2 * warp;

  Row rp[2];
#pragma unroll
  for (int q = 0; q < 2; ++q)
    rp[q] = load_row(row0 + r0 + q, n, labels, t, nullptr, scale, ab, lse,
                     g_lse, g_t);
  float dt[2] = {0.0f, 0.0f};
  float dsc[2] = {0.0f, 0.0f};

  if constexpr (kBf16) {
    load_rows_bf16(bt.xb, xn, row0, n, d, bt.dp);
    for (int i = threadIdx.x; i < kRows * (bt.dp + 4); i += kThreads)
      bt.dx[i] = 0.0f;
  } else {
    load_rows(xs, xn, row0, n, d);
    for (int i = threadIdx.x; i < kRows * d; i += kThreads) dxs[i] = 0.0f;
  }

  for (int c0 = 0; c0 < c; c0 += kCols) {
    float lt[4];
    if constexpr (kMem) load_lam(lt, lam, c0, c);
    float acc[2][4];
    if constexpr (kBf16)
      cos_tile_bf16<kMem>(acc, bt, wn, memn, lt, c0, d, c, r0);
    else
      cos_tile<kMem>(acc, xs, ws, ms, wn, memn, lt, c0, d, c, r0);
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float g = dcos_of(acc[q][i], c0 + lane + 32 * i, c, rp[q], mode,
                                has_clamp, clamp_eps, &dt[q], &dsc[q]);
        if constexpr (kBf16) {
          // rounded to bf16 for the product, each share on its own
          const int at = (r0 + q) * kLdB + lane + 32 * i;
          if constexpr (kMem) {
            bt.dcb[at] = __float2bfloat16_rn(g * (1.0f - lt[i]));
            bt.dcm[at] = __float2bfloat16_rn(g * lt[i]);
          } else {
            bt.dcb[at] = __float2bfloat16_rn(g);
          }
        } else {
          const int at = (r0 + q) * kCols + lane + 32 * i;
          if constexpr (kMem) {
            dcs[at] = g * (1.0f - lt[i]);
            dcm[at] = g * lt[i];
          } else {
            dcs[at] = g;
          }
        }
      }
    if constexpr (kBf16) {
      dx_tile_bf16<kMem>(bt, wn, memn, c0, d, c);
    } else {
      // dx[rows, d0 + lane] += dcos[rows, :] . wn[d0 + lane, tile]
      //                        (+ (dcos * lam)[rows, :] . memn[d0 + lane, tile])
      for (int d0 = 0; d0 < d; d0 += kChunk) {
        __syncthreads();  // dcs written; previous readers of ws done
        load_chunk(ws, wn, d0, c0, d, c);
        if constexpr (kMem) load_chunk(ms, memn, d0, c0, d, c);
        __syncthreads();
        float a0 = 0.0f, a1 = 0.0f;
        const float* wrow = ws + lane * (kCols + 1);
        const float* g0 = dcs + r0 * kCols;
        const float* g1 = g0 + kCols;
        for (int j = 0; j < kCols; ++j) {
          a0 = fmaf(g0[j], wrow[j], a0);
          a1 = fmaf(g1[j], wrow[j], a1);
        }
        if constexpr (kMem) {
          const float* mrow = ms + lane * (kCols + 1);
          const float* h0 = dcm + r0 * kCols;
          const float* h1 = h0 + kCols;
          for (int j = 0; j < kCols; ++j) {
            a0 = fmaf(h0[j], mrow[j], a0);
            a1 = fmaf(h1[j], mrow[j], a1);
          }
        }
        if (d0 + lane < d) {
          dxs[r0 * d + d0 + lane] += a0;
          dxs[(r0 + 1) * d + d0 + lane] += a1;
        }
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kRows * d; i += kThreads) {
    const int r = i / d;
    const int row = row0 + r;
    const int k = i - r * d;
    if (row < n)
      dx[static_cast<size_t>(row) * d + k] =
          kBf16 ? bt.dx[r * (bt.dp + 4) + k] : dxs[i];
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float st = warp_sum(dt[q]);
    const float ss = warp_sum(dsc[q]);
    const int row = row0 + r0 + q;
    if (lane == 0 && row < n) {
      // the direct path: target_logit = scale * t
      dt_out[row] = st + rp[q].g_t * rp[q].scale;
      dscale_out[row] = ss + rp[q].g_t * rp[q].t;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_ce_bwd_dx_kernel(DX_PARAMS) { bwd_dx_body<false, false>(DX_ARGS); }

// one block per SM, for the reason given at fused_ce_fwd_mem_kernel
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_bwd_dx_mem_kernel(DX_PARAMS) { bwd_dx_body<true, false>(DX_ARGS); }

template <bool kMem>
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_bwd_dx_bf16_kernel(DX_PARAMS) { bwd_dx_body<kMem, true>(DX_ARGS); }

// bwd_dw_mem fits the default register budget without spilling, so both
// instantiations share one template kernel.
template <bool kMem>
__global__ void __launch_bounds__(kThreads)
fused_ce_bwd_dw_kernel(const float* __restrict__ xn,
                       const float* __restrict__ wn,
                       const float* __restrict__ memn,
                       const float* __restrict__ lam,
                       const int* __restrict__ labels,
                       const float* __restrict__ t,
                       const float* __restrict__ scale,
                       const float* __restrict__ ab,
                       const float* __restrict__ lse,
                       const float* __restrict__ g_lse,
                       float* __restrict__ dw, int n, int d, int c, int mode,
                       int has_clamp, float clamp_eps) {
  extern __shared__ float smem[];
  float* wt = smem;                      // [d][kDwCols] this block's wn tile
  float* dws = wt + d * kDwCols;         // [d][kDwCols] dw accumulator
  float* xs = dws + d * kDwCols;         // [kRows][d]
  float* dcs = xs + kRows * d;           // [kRows][kDwCols]
  float* mt = dcs + kRows * kDwCols;     // kMem: [d][kDwCols] memn tile

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kDwCols;
  const int col = c0 + lane;
  const int r0 = 2 * warp;
  float lc = 0.0f;  // lam of the lane's column
  if constexpr (kMem) lc = col < c ? lam[col] : 0.0f;

  for (int i = threadIdx.x; i < d * kDwCols; i += kThreads) {
    const int k = i / kDwCols;
    const int j = i - k * kDwCols;
    wt[i] = c0 + j < c ? wn[static_cast<size_t>(k) * c + c0 + j] : 0.0f;
    if constexpr (kMem)
      mt[i] = c0 + j < c ? memn[static_cast<size_t>(k) * c + c0 + j] : 0.0f;
    dws[i] = 0.0f;
  }

  for (int row0 = 0; row0 < n; row0 += kRows) {
    __syncthreads();  // previous chunk's readers of xs / dcs done
    load_rows(xs, xn, row0, n, d);
    __syncthreads();
    float acc0 = 0.0f, acc1 = 0.0f;
    const float* x0 = xs + r0 * d;
    const float* x1 = x0 + d;
    for (int k = 0; k < d; ++k) {
      const float w = wt[k * kDwCols + lane];
      acc0 = fmaf(x0[k], w, acc0);
      acc1 = fmaf(x1[k], w, acc1);
    }
    if constexpr (kMem) {
      float m0 = 0.0f, m1 = 0.0f;
      for (int k = 0; k < d; ++k) {
        const float mv = mt[k * kDwCols + lane];
        m0 = fmaf(x0[k], mv, m0);
        m1 = fmaf(x1[k], mv, m1);
      }
      acc0 = (1.0f - lc) * acc0 + lc * m0;
      acc1 = (1.0f - lc) * acc1 + lc * m1;
    }
    float unused_dt = 0.0f, unused_dsc = 0.0f;
    const Row ra = load_row(row0 + r0, n, labels, t, nullptr, scale, ab, lse,
                            g_lse, nullptr);
    const Row rb = load_row(row0 + r0 + 1, n, labels, t, nullptr, scale, ab,
                            lse, g_lse, nullptr);
    float g0 = dcos_of(acc0, col, c, ra, mode, has_clamp, clamp_eps,
                       &unused_dt, &unused_dsc);
    float g1 = dcos_of(acc1, col, c, rb, mode, has_clamp, clamp_eps,
                       &unused_dt, &unused_dsc);
    if constexpr (kMem) {
      // only the weight-cosine share reaches W
      g0 *= 1.0f - lc;
      g1 *= 1.0f - lc;
    }
    dcs[r0 * kDwCols + lane] = g0;
    dcs[(r0 + 1) * kDwCols + lane] = g1;
    __syncthreads();
    // dw[k, lane] += sum_r xs[r, k] * dcos[r, lane]
    for (int k = warp; k < d; k += kThreads / 32) {
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        s = fmaf(xs[r * d + k], dcs[r * kDwCols + lane], s);
      dws[k * kDwCols + lane] += s;
    }
  }
  __syncthreads();

  if (col < c)
    for (int k = warp; k < d; k += kThreads / 32)
      dw[static_cast<size_t>(k) * c + col] = dws[k * kDwCols + lane];
}

// Byte offsets of the bf16 bwd_dw buffers (dp = D padded to 16):
//   wt    [dp][kLdWb]           bf16  the block's wn tile (mt: memn's, kMem)
//   dws   [dp][kLdP]            fp32  dw accumulator
//   xb    [kRows][dp + 8]       bf16  a chunk of rows of xn
//   dcb   [kRows][kLdWb]        bf16  bf16(dcos (* (1 - lam)))
//   part  [kSplitK][kRows][kLdP] fp32 partial cos blocks (partm: memn's)
struct DwLayout {
  size_t wt, mt, dws, xb, dcb, part, partm, total;
};

__host__ __device__ inline DwLayout dw_bf16_layout(int d, bool mem) {
  const int dp = round16(d);
  const size_t wtile = align128(sizeof(bf16) * dp * kLdWb);
  const size_t ptile = align128(sizeof(float) * kSplitK * kRows * kLdP);
  DwLayout L;
  size_t o = 0;
  L.wt = o;
  o += wtile;
  L.mt = o;
  o += mem ? wtile : 0;
  L.dws = o;
  o += align128(sizeof(float) * dp * kLdP);
  L.xb = o;
  o += align128(sizeof(bf16) * kRows * (dp + 8));
  L.dcb = o;
  o += align128(sizeof(bf16) * kRows * kLdWb);
  L.part = o;
  o += ptile;
  L.partm = o;
  o += mem ? ptile : 0;
  L.total = o;
  return L;
}

// bwd_dw on the tensor cores: a block per 32 classes, as in fp32. Per chunk
// of 16 rows, warp w computes the 16 x 16 cosine block of columns
// 16 (w % 2).. over the k-steps w / 2, w / 2 + 4, ... (four warps per block,
// their partial sums added in the epilogue), then the warps share the
// (dp / 16) x 2 blocks of dw += bf16(xn)^T . bf16(dcos (* (1 - lam))).
template <bool kMem>
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_bwd_dw_bf16_kernel(const float* __restrict__ xn,
                            const float* __restrict__ wn,
                            const float* __restrict__ memn,
                            const float* __restrict__ lam,
                            const int* __restrict__ labels,
                            const float* __restrict__ t,
                            const float* __restrict__ scale,
                            const float* __restrict__ ab,
                            const float* __restrict__ lse,
                            const float* __restrict__ g_lse,
                            float* __restrict__ dw, int n, int d, int c,
                            int mode, int has_clamp, float clamp_eps) {
  extern __shared__ float smem[];
  char* base = reinterpret_cast<char*>(smem);
  const DwLayout L = dw_bf16_layout(d, kMem);
  bf16* wt = reinterpret_cast<bf16*>(base + L.wt);
  bf16* mt = reinterpret_cast<bf16*>(base + L.mt);
  float* dws = reinterpret_cast<float*>(base + L.dws);
  bf16* xb = reinterpret_cast<bf16*>(base + L.xb);
  bf16* dcb = reinterpret_cast<bf16*>(base + L.dcb);
  float* part = reinterpret_cast<float*>(base + L.part);
  float* partm = reinterpret_cast<float*>(base + L.partm);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kDwCols;
  const int col = c0 + lane;
  const int r0 = 2 * warp;
  const int dp = round16(d);
  const int ksteps = dp / 16;
  const int ct = warp & 1;   // column block of the cosine
  const int ks0 = warp >> 1;  // first k-step of this warp's share
  float lc = 0.0f;  // lam of the lane's column
  if constexpr (kMem) lc = col < c ? lam[col] : 0.0f;

  for (int i = threadIdx.x; i < dp * kDwCols; i += kThreads) {
    const int k = i / kDwCols;
    const int j = i - k * kDwCols;
    const bool in = k < d && c0 + j < c;
    const size_t at = static_cast<size_t>(k) * c + c0 + j;
    wt[k * kLdWb + j] = __float2bfloat16_rn(in ? wn[at] : 0.0f);
    if constexpr (kMem)
      mt[k * kLdWb + j] = __float2bfloat16_rn(in ? memn[at] : 0.0f);
    dws[k * kLdP + j] = 0.0f;
  }

  for (int row0 = 0; row0 < n; row0 += kRows) {
    __syncthreads();  // tiles staged; previous readers of xb / dcb done
    load_rows_bf16(xb, xn, row0, n, d, dp);
    __syncthreads();
    FragC fc, fm;
    wmma::fill_fragment(fc, 0.0f);
    if constexpr (kMem) wmma::fill_fragment(fm, 0.0f);
    for (int ks = ks0; ks < ksteps; ks += kSplitK) {
      FragA a;
      FragB b;
      wmma::load_matrix_sync(a, xb + ks * 16, dp + 8);
      wmma::load_matrix_sync(b, wt + ks * 16 * kLdWb + ct * 16, kLdWb);
      wmma::mma_sync(fc, a, b, fc);
      if constexpr (kMem) {
        wmma::load_matrix_sync(b, mt + ks * 16 * kLdWb + ct * 16, kLdWb);
        wmma::mma_sync(fm, a, b, fm);
      }
    }
    wmma::store_matrix_sync(part + ks0 * kRows * kLdP + ct * 16, fc, kLdP,
                            wmma::mem_row_major);
    if constexpr (kMem)
      wmma::store_matrix_sync(partm + ks0 * kRows * kLdP + ct * 16, fm,
                              kLdP, wmma::mem_row_major);
    __syncthreads();
    float acc0 = 0.0f, acc1 = 0.0f, m0 = 0.0f, m1 = 0.0f;
#pragma unroll
    for (int p = 0; p < kSplitK; ++p) {
      const int at = p * kRows * kLdP + r0 * kLdP + lane;
      acc0 += part[at];
      acc1 += part[at + kLdP];
      if constexpr (kMem) {
        m0 += partm[at];
        m1 += partm[at + kLdP];
      }
    }
    if constexpr (kMem) {
      acc0 = (1.0f - lc) * acc0 + lc * m0;
      acc1 = (1.0f - lc) * acc1 + lc * m1;
    }
    float unused_dt = 0.0f, unused_dsc = 0.0f;
    const Row ra = load_row(row0 + r0, n, labels, t, nullptr, scale, ab, lse,
                            g_lse, nullptr);
    const Row rb = load_row(row0 + r0 + 1, n, labels, t, nullptr, scale, ab,
                            lse, g_lse, nullptr);
    float g0 = dcos_of(acc0, col, c, ra, mode, has_clamp, clamp_eps,
                       &unused_dt, &unused_dsc);
    float g1 = dcos_of(acc1, col, c, rb, mode, has_clamp, clamp_eps,
                       &unused_dt, &unused_dsc);
    if constexpr (kMem) {
      g0 *= 1.0f - lc;
      g1 *= 1.0f - lc;
    }
    dcb[r0 * kLdWb + lane] = __float2bfloat16_rn(g0);
    dcb[(r0 + 1) * kLdWb + lane] = __float2bfloat16_rn(g1);
    __syncthreads();
    for (int tile = warp; tile < 2 * ksteps; tile += kThreads / 32) {
      const int mt_row = tile >> 1;
      const int nt = tile & 1;
      float* out = dws + mt_row * 16 * kLdP + nt * 16;
      FragC f;
      FragAt a;
      FragB b;
      wmma::load_matrix_sync(f, out, kLdP, wmma::mem_row_major);
      wmma::load_matrix_sync(a, xb + mt_row * 16, dp + 8);
      wmma::load_matrix_sync(b, dcb + nt * 16, kLdWb);
      wmma::mma_sync(f, a, b, f);
      wmma::store_matrix_sync(out, f, kLdP, wmma::mem_row_major);
    }
  }
  __syncthreads();

  if (col < c)
    for (int k = warp; k < d; k += kThreads / 32)
      dw[static_cast<size_t>(k) * c + col] = dws[k * kLdP + lane];
}

size_t fwd_smem(int d, bool mem) {
  return sizeof(float) * (kRows * d + (mem ? 2 : 1) * kChunk * (kCols + 1));
}
size_t dx_smem(int d, bool mem) {
  return sizeof(float) * (2 * kRows * d + (mem ? 2 : 1) *
                          (kChunk * (kCols + 1) + kRows * kCols));
}
size_t dw_smem(int d, bool mem) {
  return sizeof(float) * ((mem ? 3 : 2) * d * kDwCols + kRows * d +
                          kRows * kDwCols);
}

size_t smem_bytes(int which, int d) {
  const bool mem = which % 6 >= 3;
  const int k = which % 3;
  if (which >= 6)
    return k == 2 ? dw_bf16_layout(d, mem).total
                  : bf_layout(d, mem, k == 1).total;
  return k == 0 ? fwd_smem(d, mem) : k == 1 ? dx_smem(d, mem) : dw_smem(d, mem);
}

template <bool kMem, bool kBf16>
int launch_fwd(const float* xn, const float* wn, const float* memn,
               const float* lam, const int* labels, const float* t,
               const float* tcos, const float* scale, const float* ab,
               float* lse, float* tlogit, float* higher, int n, int d, int c,
               int mode, int has_clamp, float clamp_eps, void* stream) {
  const size_t smem = smem_bytes((kBf16 ? 6 : 0) + (kMem ? 3 : 0), d);
  auto* kernel = kBf16 ? fused_ce_fwd_bf16_kernel<kMem>
                 : kMem ? fused_ce_fwd_mem_kernel : fused_ce_fwd_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kRows - 1) / kRows;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xn, wn, memn, lam, labels, t, tcos, scale, ab, lse, tlogit, higher, n,
      d, c, mode, has_clamp, clamp_eps);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMem, bool kBf16>
int launch_bwd_dx(const float* xn, const float* wn, const float* memn,
                  const float* lam, const int* labels, const float* t,
                  const float* scale, const float* ab, const float* lse,
                  const float* g_lse, const float* g_t, float* dx, float* dt,
                  float* dscale, int n, int d, int c, int mode, int has_clamp,
                  float clamp_eps, void* stream) {
  const size_t smem = smem_bytes((kBf16 ? 7 : 1) + (kMem ? 3 : 0), d);
  auto* kernel = kBf16 ? fused_ce_bwd_dx_bf16_kernel<kMem>
                 : kMem ? fused_ce_bwd_dx_mem_kernel : fused_ce_bwd_dx_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kRows - 1) / kRows;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xn, wn, memn, lam, labels, t, scale, ab, lse, g_lse, g_t, dx, dt,
      dscale, n, d, c, mode, has_clamp, clamp_eps);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMem, bool kBf16>
int launch_bwd_dw(const float* xn, const float* wn, const float* memn,
                  const float* lam, const int* labels, const float* t,
                  const float* scale, const float* ab, const float* lse,
                  const float* g_lse, float* dw, int n, int d, int c, int mode,
                  int has_clamp, float clamp_eps, void* stream) {
  const size_t smem = smem_bytes((kBf16 ? 8 : 2) + (kMem ? 3 : 0), d);
  auto* kernel = kBf16 ? fused_ce_bwd_dw_bf16_kernel<kMem>
                       : fused_ce_bwd_dw_kernel<kMem>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (c + kDwCols - 1) / kDwCols;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xn, wn, memn, lam, labels, t, scale, ab, lse, g_lse, dw, n, d, c, mode,
      has_clamp, clamp_eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared-memory bytes each kernel needs at embedding width d; the wrapper
// refuses widths whose need exceeds the card's per-block limit. which: 0 fwd,
// 1 bwd_dx, 2 bwd_dw; 3, 4, 5 the same with the memory blend; 6-11 the bf16
// kernels in the same order.
size_t fused_ce_smem_bytes(int which, int d) { return smem_bytes(which, d); }

// The six entries, each once for IEEE fp32 products (SUFFIX empty, BF16
// false) and once for bf16 tensor-core products (_bf16, true).
#define FUSED_CE_ENTRIES(SUFFIX, BF16)                                       \
  int fused_ce_fwd##SUFFIX(                                                  \
      const float* xn, const float* wn, const int* labels, const float* t,   \
      const float* tcos, const float* scale, const float* ab, float* lse,    \
      float* tlogit, float* higher, int n, int d, int c, int mode,           \
      int has_clamp, float clamp_eps, void* stream) {                        \
    return launch_fwd<false, BF16>(xn, wn, nullptr, nullptr, labels, t,      \
                                   tcos, scale, ab, lse, tlogit, higher, n,  \
                                   d, c, mode, has_clamp, clamp_eps,         \
                                   stream);                                  \
  }                                                                          \
  int fused_ce_bwd_dx##SUFFIX(                                               \
      const float* xn, const float* wn, const int* labels, const float* t,   \
      const float* scale, const float* ab, const float* lse,                 \
      const float* g_lse, const float* g_t, float* dx, float* dt,            \
      float* dscale, int n, int d, int c, int mode, int has_clamp,           \
      float clamp_eps, void* stream) {                                       \
    return launch_bwd_dx<false, BF16>(xn, wn, nullptr, nullptr, labels, t,   \
                                      scale, ab, lse, g_lse, g_t, dx, dt,    \
                                      dscale, n, d, c, mode, has_clamp,      \
                                      clamp_eps, stream);                    \
  }                                                                          \
  int fused_ce_bwd_dw##SUFFIX(                                               \
      const float* xn, const float* wn, const int* labels, const float* t,   \
      const float* scale, const float* ab, const float* lse,                 \
      const float* g_lse, float* dw, int n, int d, int c, int mode,          \
      int has_clamp, float clamp_eps, void* stream) {                        \
    return launch_bwd_dw<false, BF16>(xn, wn, nullptr, nullptr, labels, t,   \
                                      scale, ab, lse, g_lse, dw, n, d, c,    \
                                      mode, has_clamp, clamp_eps, stream);   \
  }                                                                          \
  int fused_ce_fwd_mem##SUFFIX(                                              \
      const float* xn, const float* wn, const float* memn, const float* lam, \
      const int* labels, const float* t, const float* tcos,                  \
      const float* scale, const float* ab, float* lse, float* tlogit,        \
      float* higher, int n, int d, int c, int mode, int has_clamp,           \
      float clamp_eps, void* stream) {                                       \
    return launch_fwd<true, BF16>(xn, wn, memn, lam, labels, t, tcos, scale, \
                                  ab, lse, tlogit, higher, n, d, c, mode,    \
                                  has_clamp, clamp_eps, stream);             \
  }                                                                          \
  int fused_ce_bwd_dx_mem##SUFFIX(                                           \
      const float* xn, const float* wn, const float* memn, const float* lam, \
      const int* labels, const float* t, const float* scale,                 \
      const float* ab, const float* lse, const float* g_lse,                 \
      const float* g_t, float* dx, float* dt, float* dscale, int n, int d,   \
      int c, int mode, int has_clamp, float clamp_eps, void* stream) {       \
    return launch_bwd_dx<true, BF16>(xn, wn, memn, lam, labels, t, scale,    \
                                     ab, lse, g_lse, g_t, dx, dt, dscale, n, \
                                     d, c, mode, has_clamp, clamp_eps,       \
                                     stream);                                \
  }                                                                          \
  int fused_ce_bwd_dw_mem##SUFFIX(                                           \
      const float* xn, const float* wn, const float* memn, const float* lam, \
      const int* labels, const float* t, const float* scale,                 \
      const float* ab, const float* lse, const float* g_lse, float* dw,      \
      int n, int d, int c, int mode, int has_clamp, float clamp_eps,         \
      void* stream) {                                                        \
    return launch_bwd_dw<true, BF16>(xn, wn, memn, lam, labels, t, scale,    \
                                     ab, lse, g_lse, dw, n, d, c, mode,      \
                                     has_clamp, clamp_eps, stream);          \
  }

FUSED_CE_ENTRIES(, false)
FUSED_CE_ENTRIES(_bf16, true)

}  // extern "C"
