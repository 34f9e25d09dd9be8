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
// is bound by fp32 operations, not by bytes. fwd needs P (0.083 ms), bwd_dx
// and bwd_dw 2P each (cos again, then their own product; 0.166 ms). With the
// blend each product runs over wn and over memn: fwd_mem 2P (0.166 ms),
// bwd_dx_mem 4P (0.331 ms), bwd_dw_mem 3P (0.248 ms), against 43 MB of wn +
// memn. These are the dense counts: VPL's lam is 0.15 on ~99% of the classes
// after ~100 steps at b512, and the kernels do the dense work whatever lam
// holds. The products run in IEEE fp32 on the CUDA cores, never TF32: the
// acos-based margins downstream need full fp32 cosines, as the JAX package
// runs this math at Precision.HIGHEST.
//
// fp32 forward and dx (fused_ce_fwd(_mem), fused_ce_bwd_dx(_mem)): split-C.
// On the TPU the class axis is a sequential grid axis and per-row state
// (running max, sum, rank count; the dx accumulator) sits in VMEM across it.
// A block of 16 rows sweeping all of C would leave 100 of the 132 SMs idle
// at N=512. Here:
//   - the grid is row tiles (64 rows in fwd, 32 in bwd_dx) x class ranges;
//     the number of ranges is chosen at launch from N, C and the SM count so
//     that at least two blocks run per SM where C allows (range_cols); each
//     block sweeps its range in 256-wide class tiles with the online
//     logsumexp (fwd) or the dx accumulation (bwd_dx);
//   - each range writes partials to a workspace the wrapper allocates (fwd:
//     m, l, higher per row, O(S*N); bwd_dx: dx, dt, dscale per row, O(S*N*D))
//     and a second launch from the same entry combines them in a fixed order
//     (lse = M + log sum_s l_s e^(m_s - M), the rest summed): no atomics, so
//     two launches on the same inputs give bitwise-equal results, and no
//     [N, C] tensor reaches device memory. An empty range carries m = -1e30,
//     l = 0, which combines to nothing;
//   - the products are register-tiled IEEE fp32 FMA on the CUDA cores: a
//     thread owns 8 rows x 8 classes of the fwd cosine tile (4 x 8 in
//     bwd_dx), read as float4s from shared memory, 4 shared loads per 64
//     FMAs (3 per 32); with the blend the memn product shares the xn
//     operand. The epilogue runs on the accumulators in registers. bwd_dx
//     keeps its dx accumulator (8 rows x 8 columns of D a thread) in
//     registers across its whole range; dcos goes through a [256][32] shared
//     tile between the two products, which with the blend run as one
//     product over a doubled depth, [dcos (1 - lam) | dcos lam] x [wn; memn];
//   - operands are staged with cp.async into a 3-stage ring, so the copies of
//     stage k + 2 run under the products of stage k. The copies are 4 bytes
//     each (cp.async.ca): C = 10,575 is odd, so rows of wn and memn are only
//     4-byte aligned, and 4-byte copies also transpose xn into [k][row] on
//     the way in. The same ring serves both products of bwd_dx: the cosine
//     stages (16 deep in D) and the dx stages (8 classes, all of D).
// fp32 dw (fused_ce_bwd_dw(_mem)): class tiles x row ranges. It replaces
// _bwd_dw_kernel (K3b) and the dw half of _bwd_fused_kernel (K2; with the
// blend their has_mem bodies, K4), where dw [D, block_c] sits in VMEM while
// the grid's sequential row axis sweeps N. The backward is two launches
// instead of K2's single sweep (dx reduces over C, dw over N); the price is
// a fourth product (cos recomputed in each). Bound by fp32 operations like
// bwd_dx, with the roles of rows and classes swapped:
//   - the grid is 32-wide class tiles x row ranges; a block keeps its
//     tile's dw accumulator [D][32] in registers (8 columns of D x 8 classes
//     a thread) while it sweeps its range in 256-row tiles, and stores it
//     once, coalesced along C through shared memory. The number of ranges S
//     is chosen at launch from N, C and the SM count (range_rows): at the
//     training shape the 331 class tiles alone fill the card and S = 1; at
//     small C or large N per class tile S > 1, each range writes dw
//     partials [S][D][C] to a workspace the wrapper allocates and a combine
//     launch sums them in range order (no atomics: two launches on the
//     same inputs give bitwise-equal dw);
//   - per row tile the block recomputes the cosine tile [256 rows][32
//     classes] with 4 x 8 register tiles (3 float4 shared loads per 32
//     FMAs; with the blend the memn product shares the xn operand), runs
//     dcos_of on the accumulators, takes the (1 - lam) share with the
//     blend, and passes dcos through a [256][32] shared tile to the dw
//     product, which streams xn in stages of 8 rows x all of D (4 float4
//     loads per 64 FMAs);
//   - every operand is staged with 4-byte cp.async copies into the same
//     3-stage ring as bwd_dx (C is odd; xn is transposed on the way in for
//     the cosine product); no [N, C] tensor reaches device memory.
//
// Shared memory per block (the limit is 232,448 B): fwd 64,768 B, fwd_mem
// 113,920 B, bwd_dx 90,112 B, bwd_dx_mem 172,032 B, bwd_dw 92,928 B,
// bwd_dw_mem 99,072 B at any D up to 512 (the widest the split dx and dw
// kernels take: 8 warps x 64 columns of the accumulator). A width above 512
// is refused by the wrapper.
//   The bf16 kernels (layouts at fwd_bf16_smem, dx_bf16_smem and
//   dw_bf16_layout): fwd 101,888 B, fwd_mem 134,656 B, bwd_dx 108,800 B,
//   bwd_dx_mem 183,040 B, bwd_dw 217,600 B, bwd_dw_mem 190,720 B at
//   D = 512. bwd_dx(_mem) and bwd_dw(_mem) take D up to 512 (8 warps x 64
//   columns of the dx or dw accumulator, as the fp32 dx and dw); fwd takes
//   up to 1,520, fwd_mem up to 1,264.
//
// bf16 products (K5: the mm_dtype=jnp.bfloat16 option of every kernel above,
// fused_head.py:119-126, 192-196, 237-243, 269-276, 307, 352-360, 396-407):
//   fused_ce_{fwd,bwd_dx,bwd_dw}_bf16 and fused_ce_{fwd,bwd_dx,bwd_dw}_mem_bf16.
// The operands stay fp32 in device memory, as in JAX, and are rounded to
// bf16 (__float2bfloat16_rn, round to nearest even) at exactly the six
// places of the Pallas kernels: xn and wn before every cosine product,
// memn, dcos before the dx and dw products, and with the blend
// dcos * (1 - lam) and dcos * lam, each rounded on its own. Every product
// runs on the tensor cores with fp32 accumulators.
//   - fwd(_mem) and bwd_dx(_mem): split-C like their fp32 counterparts, with
//     mma.sync on operands rounded once by a pre-pass; see "bf16 split-C
//     forward" and "bf16 split-C dx" below.
//   - bwd_dw(_mem): 32-wide class tiles x row ranges like the fp32 dw, on
//     mma.sync, with xn rounded once by a pre-pass; see "bf16 dw" below.
// What bounds them at N=512, D=512, C=10,575: one product is 5.5 GFLOP,
// 5.6 us at 989 TFLOP/s dense bf16, against 21.7 MB of fp32 wn (6.5 us at
// 3.35 TB/s): the forward is bound by bytes, the backward kernels (two or
// three products) lie close to the line.

// C interface: each entry launches on the given stream and returns
// cudaGetLastError() (0 on success). All pointers are device pointers to
// contiguous fp32 (labels int32) arrays; ab is [N, 2] with a = ab[:, 0],
// b = ab[:, 1]; wn, memn and dw are [D, C] row-major, lam is [C].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // 8 warps
constexpr int kDwCols = 32;     // class-tile width of both bwd_dw
constexpr float kNegInf = -1e30f;

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

// ---- bf16 tiles --------------------------------------------------------

__host__ __device__ constexpr int round16(int d) { return (d + 15) & ~15; }
__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) & ~static_cast<size_t>(127);
}

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

// ---- fp32 split-C forward and dx (see the note at the head of the file) --
//
// Thread layout of the cosine tile [R rows][256 classes] (R = 64 in fwd, 32
// in bwd_dx): warp w covers rows R/2 (w / 4) .. + R/2 - 1 and classes
// 64 (w % 4) .. + 63; lane l within it rows 4 (l / 8) + 16 h + {0..3} (h <
// R / 32) and classes 4 (l % 8) + {0..3, 32..35}, so a k step reads R/2 x 4 B
// of xn and 256 B of wn per warp (broadcast across lanes) for its R/32 x
// 1,024 FMAs. Each wn element staged from L2 feeds 2R FLOP: the forward's
// 64-row tile halves the L2 traffic per FLOP of a 32-row one. The dx tile
// [32 rows][D]: warp w covers D columns 64 w .. + 63; lane l rows 8 (l / 8)
// .. + 7 and columns 4 (l % 8) + {0..3, 32..35}; its 64 accumulators leave
// no room for a 64-row tile.

constexpr int kFwdRows = 64;     // rows of a forward block tile
constexpr int kDxRows = 32;      // rows of a bwd_dx block tile
constexpr int kSplitCols = 256;  // class-tile width
constexpr int kDepth = 16;       // D depth of one cosine stage
constexpr int kDxDepth = 8;      // classes of one dx stage
constexpr int kStages = 3;       // cp.async ring
constexpr int kMaxSplitD = 512;  // widest D of the split dx kernels (8 x 64)
static_assert(kSplitCols == kThreads, "one staged class column per thread");
static_assert(kThreads == 256, "the 2 x 4 warp layout above");

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ constexpr int round4(int d) { return (d + 3) & ~3; }
// pitch of a staged wn^T row: every warp's 64 columns, and 4 more so that
// the 8 rows of a stage start on different banks
__host__ __device__ constexpr int dx_pitch(int d) {
  return ((d + 63) & ~63) + 4;
}

// Pitch of a staged xn^T chunk of R rows (float4 rows, 16-byte aligned).
__host__ __device__ constexpr int xs_pitch(int rows) { return rows + 4; }
__host__ __device__ constexpr int split_rows(bool dx) {
  return dx ? kDxRows : kFwdRows;
}

// Floats of one ring slot: a cosine stage (xn^T [kDepth][xs_pitch], wn
// [kDepth][kSplitCols], with kMem memn too) or, in bwd_dx, a dx stage (wn^T
// [kDxDepth][dx_pitch], with kMem memn^T too), whichever is larger.
__host__ __device__ inline int split_slot(int d, bool mem, bool dx) {
  const int ops = mem ? 2 : 1;
  const int cos =
      kDepth * xs_pitch(split_rows(dx)) + ops * kDepth * kSplitCols;
  const int dxs = dx ? ops * kDxDepth * dx_pitch(d) : 0;
  return cos > dxs ? cos : dxs;
}

// Bytes: the block's Row scalars, the ring and, in bwd_dx, the dcos tiles
// [kSplitCols][kDxRows] (with kMem dcos * (1 - lam) and dcos * lam).
__host__ __device__ inline size_t split_smem(int d, bool mem, bool dx) {
  const int tiles = dx ? (mem ? 2 : 1) * kSplitCols * kDxRows : 0;
  return sizeof(Row) * split_rows(dx) +
         sizeof(float) *
             (kStages * static_cast<size_t>(split_slot(d, mem, dx)) + tiles);
}

// 4-byte asynchronous copy global -> shared; zero-fills when !pred (src is
// then not read but must be a valid address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(at),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// First row and first class of the thread's share of an R-row cosine tile:
// its row q is row0 + (q & 3) + 16 (q >> 2), its element e is in class
// col0 + (e & 3) + 32 (e >> 2).
template <int kRowsT>
__device__ __forceinline__ int cos_row0() {
  return kRowsT / 2 * (threadIdx.x >> 7) + 4 * ((threadIdx.x & 31) >> 3);
}
__device__ __forceinline__ int cos_row(int row0, int q) {
  return row0 + (q & 3) + 16 * (q >> 2);
}
__device__ __forceinline__ int cos_col0() {
  return 64 * ((threadIdx.x >> 5) & 3) + 4 * (threadIdx.x & 7);
}
__device__ __forceinline__ int elem_col(int col0, int e) {
  return col0 + (e & 3) + 32 * (e >> 2);
}

// Stage xn[row0:row0+R, d0:d0+16] transposed into xs [kDepth][xs_pitch(R)],
// zero past N and D; 16 lanes read 16 floats of a row.
template <int kRowsT>
__device__ __forceinline__ void stage_xt(float* xs, const float* xn, int row0,
                                         int n, int d, int d0) {
  constexpr int kPitch = xs_pitch(kRowsT);
#pragma unroll
  for (int it = 0; it < kDepth * kRowsT / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int k = i % kDepth;
    const int r = i / kDepth;
    const int row = row0 + r;
    const bool in = row < n && d0 + k < d;
    cp_async4(xs + k * kPitch + r,
              in ? xn + static_cast<size_t>(row) * d + d0 + k : xn, in);
  }
}

// Stage xn[row0:row0+R, d0:d0+16] transposed into xs [kDepth][xs_pitch(R)]
// and wn[d0:d0+16, c0:c0+256] into ws [kDepth][kSplitCols] (kMem: memn into
// ms beside it), zero past N, D and C. wn is read one row of 256 classes
// per k.
template <bool kMem, int kRowsT>
__device__ __forceinline__ void stage_cos(float* slot, const float* xn,
                                          const float* wn, const float* memn,
                                          int row0, int n, int d, int c,
                                          int c0, int d0) {
  float* xs = slot;
  float* ws = xs + kDepth * xs_pitch(kRowsT);
  float* ms = ws + kDepth * kSplitCols;
  stage_xt<kRowsT>(xs, xn, row0, n, d, d0);
  const int col = c0 + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    const bool in = d0 + k < d && col < c;
    const size_t at = static_cast<size_t>(d0 + k) * c + col;
    cp_async4(ws + k * kSplitCols + threadIdx.x, in ? wn + at : wn, in);
    if constexpr (kMem)
      cp_async4(ms + k * kSplitCols + threadIdx.x, in ? memn + at : memn, in);
  }
}

// Stage wn[:, j0:j0+8] transposed into wt [kDxDepth][dx_pitch] (kMem: memn
// into mt beside it), zero past C; columns of D past d are left as they are
// (the dx accumulators they feed are never stored). 8 consecutive lanes read
// 8 consecutive classes of one row of wn.
template <bool kMem>
__device__ __forceinline__ void stage_dx(float* slot, const float* wn,
                                         const float* memn, int d, int c,
                                         int j0) {
  const int pitch = dx_pitch(d);
  float* wt = slot;
  float* mt = slot + kDxDepth * pitch;
  for (int i = threadIdx.x; i < kDxDepth * d; i += kThreads) {
    const int jj = i % kDxDepth;
    const int k = i / kDxDepth;
    const bool in = j0 + jj < c;
    const size_t at = static_cast<size_t>(k) * c + j0 + jj;
    cp_async4(wt + jj * pitch + k, in ? wn + at : wn, in);
    if constexpr (kMem)
      cp_async4(mt + jj * pitch + k, in ? memn + at : memn, in);
  }
}

// acc[4h + q][e] += a[h][q] * (b0 | b1)[e]: a (4 kGroups) x 8 tile, the
// operands as float4s.
template <int kGroups>
__device__ __forceinline__ void fma_tile(float acc[4 * kGroups][8],
                                         const float4 (&a)[kGroups],
                                         float4 b0, float4 b1) {
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int h = 0; h < kGroups; ++h) {
    const float av[4] = {a[h].x, a[h].y, a[h].z, a[h].w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[4 * h + q][e] = fmaf(av[q], bv[e], acc[4 * h + q][e]);
  }
}

// One cosine stage: kDepth steps of xn . wn (kMem: and xn . memn, sharing
// the xn operand) into the thread's (R / 8) x 8 tiles, in order of D.
template <bool kMem, int kRowsT>
__device__ __forceinline__ void cos_stage(float acc[kRowsT / 8][8],
                                          float accm[kRowsT / 8][8],
                                          const float* slot, int r0, int c0) {
  constexpr int kPitch = xs_pitch(kRowsT);
  constexpr int kGroups = kRowsT / 32;
  const float* xs = slot;
  const float* ws = xs + kDepth * kPitch;
  const float* ms = ws + kDepth * kSplitCols;
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    float4 a[kGroups];
#pragma unroll
    for (int h = 0; h < kGroups; ++h) a[h] = ld4(xs + k * kPitch + r0 + 16 * h);
    const float* w = ws + k * kSplitCols + c0;
    fma_tile<kGroups>(acc, a, ld4(w), ld4(w + 32));
    if constexpr (kMem) {
      const float* m = ms + k * kSplitCols + c0;
      fma_tile<kGroups>(accm, a, ld4(m), ld4(m + 32));
    }
  }
}

// One dx stage: dx[8 rows, 8 columns of D] += dcos[rows, j] . wn[cols, j]
// (kMem: + (dcos * lam)[rows, j] . memn[cols, j]) over the stage's 8
// classes; r0 / k0 are the thread's first row and D column.
template <bool kMem>
__device__ __forceinline__ void dx_stage(float dxa[8][8], const float* slot,
                                         const float* dct, const float* dmt,
                                         int j0, int d, int r0, int k0) {
  const int pitch = dx_pitch(d);
  const float* wt = slot + k0;
  const float* mt = wt + kDxDepth * pitch;
#pragma unroll
  for (int jj = 0; jj < kDxDepth; ++jj) {
    const int at = (j0 + jj) * kDxRows + r0;
    const float4 g[2] = {ld4(dct + at), ld4(dct + at + 4)};
    fma_tile<2>(dxa, g, ld4(wt + jj * pitch), ld4(wt + jj * pitch + 32));
    if constexpr (kMem) {
      const float4 h[2] = {ld4(dmt + at), ld4(dmt + at + 4)};
      fma_tile<2>(dxa, h, ld4(mt + jj * pitch), ld4(mt + jj * pitch + 32));
    }
  }
}

// Columns [c_lo, c_hi) of the block's class range; tiles of it.
__device__ __forceinline__ int range_tiles(int c, int range_cols, int* c_lo) {
  *c_lo = blockIdx.y * range_cols;
  const int c_hi = min(c, *c_lo + range_cols);
  return c_hi > *c_lo ? ceil_div(c_hi - *c_lo, kSplitCols) : 0;
}

// Sum over the 8 lanes of a row group (lanes 8g .. 8g + 7).
__device__ __forceinline__ float sum8(float v) {
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The forward over one class range: per row the range's max logit m, sum
// l = sum exp(logit - m) and `higher` count, into part [S][3][N]. One block
// per SM: a thread's 64 accumulators (128 with the blend) and the epilogue
// spilled at the 128 registers that two blocks would leave; one block ran as
// fast as two (H100, chip_smoke.py's shapes).
template <bool kMem>
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_fwd_split_kernel(const float* __restrict__ xn,
                          const float* __restrict__ wn,
                          const float* __restrict__ memn,
                          const float* __restrict__ lam,
                          const int* __restrict__ labels,
                          const float* __restrict__ t,
                          const float* __restrict__ tcos,
                          const float* __restrict__ scale,
                          const float* __restrict__ ab,
                          float* __restrict__ part, int n, int d, int c,
                          int range_cols, int mode, int has_clamp,
                          float clamp_eps) {
  extern __shared__ float4 smem4[];
  constexpr int kR = kFwdRows / 8;  // rows of the thread
  Row* rows = reinterpret_cast<Row*>(smem4);
  float* ring = reinterpret_cast<float*>(rows + kFwdRows);
  const int slot = split_slot(d, kMem, false);
  const int r0 = cos_row0<kFwdRows>();
  const int col0 = cos_col0();
  const int row0 = blockIdx.x * kFwdRows;
  int c_lo;
  const int nk = ceil_div(d, kDepth);
  const int total = range_tiles(c, range_cols, &c_lo) * nk;
  if (threadIdx.x < kFwdRows)
    rows[threadIdx.x] = load_row(row0 + threadIdx.x, n, labels, t, tcos,
                                 scale, ab, nullptr, nullptr, nullptr);

  auto prefetch = [&](int i) {
    stage_cos<kMem, kFwdRows>(ring + (i % kStages) * slot, xn, wn, memn,
                              row0, n, d, c, c_lo + (i / nk) * kSplitCols,
                              (i % nk) * kDepth);
  };
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total) prefetch(i);
    cp_async_commit();
  }
  float acc[kR][8], accm[kR][8];
  float m[kR], l[kR], hi[kR];
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    m[q] = kNegInf;
    l[q] = 0.0f;
    hi[q] = 0.0f;
  }
  for (int i = 0; i < total; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i landed; stage i - 1's readers done
    if (i + kStages - 1 < total) prefetch(i + kStages - 1);
    cp_async_commit();
    const int k = i % nk;
    if (k == 0) {
#pragma unroll
      for (int q = 0; q < kR; ++q)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[q][e] = accm[q][e] = 0.0f;
    }
    cos_stage<kMem, kFwdRows>(acc, accm, ring + (i % kStages) * slot, r0,
                              col0);
    if (k != nk - 1) continue;
    // the class tile is complete: margin, online logsumexp and `higher`
    // over the thread's own 8 columns
    const int c0 = c_lo + (i / nk) * kSplitCols + col0;
    if constexpr (kMem) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = elem_col(c0, e);
        const float lt = col < c ? lam[col] : 0.0f;
#pragma unroll
        for (int q = 0; q < kR; ++q)
          acc[q][e] = (1.0f - lt) * acc[q][e] + lt * accm[q][e];
      }
    }
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      const Row& r = rows[cos_row(r0, q)];
      float logit[8];
      float tile_max = kNegInf;
      float cnt = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = elem_col(c0, e);
        float cs = acc[q][e];  // blended with the memory's above
        if (has_clamp)
          cs = fminf(fmaxf(cs, -1.0f + clamp_eps), 1.0f - clamp_eps);
        const bool in_range = col < c;
        const bool is_target = col == r.label;
        logit[e] = in_range ? r.scale * (is_target ? r.t
                                                   : h_fn(mode, cs, r.a, r.b))
                            : kNegInf;
        // pre-margin rank statistic for top-k accuracy (on the blended,
        // clamped cos): the target column never counts itself
        if (in_range && !is_target && cs > r.tcos) cnt += 1.0f;
        tile_max = fmaxf(tile_max, logit[e]);
      }
      const float m_new = fmaxf(m[q], tile_max);
      float s = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (elem_col(c0, e) < c) s += expf(logit[e] - m_new);
      l[q] = l[q] * expf(m[q] - m_new) + s;
      m[q] = m_new;
      hi[q] += cnt;
    }
  }
  cp_async_wait<0>();

  // merge the row's (m, l, higher) over the 8 lanes of its row group (a
  // butterfly), then over the 4 warps of its row half (in order of warp)
#pragma unroll
  for (int q = 0; q < kR; ++q) {
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[q], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[q], o);
      const float mm = fmaxf(m[q], mo);
      l[q] = l[q] * expf(m[q] - mm) + lo * expf(mo - mm);
      m[q] = mm;
    }
    hi[q] = sum8(hi[q]);
  }
  __syncthreads();  // the ring is free: [4 warps][kFwdRows][3]
  float* red = ring;
  const int wc = (threadIdx.x >> 5) & 3;
  if ((threadIdx.x & 7) == 0) {
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      float* p = red + (wc * kFwdRows + cos_row(r0, q)) * 3;
      p[0] = m[q];
      p[1] = l[q];
      p[2] = hi[q];
    }
  }
  __syncthreads();
  const int row = row0 + threadIdx.x;
  if (threadIdx.x < kFwdRows && row < n) {
    float mq = kNegInf, lq = 0.0f, h = 0.0f;
    for (int w = 0; w < 4; ++w) {
      const float* p = red + (w * kFwdRows + threadIdx.x) * 3;
      const float mm = fmaxf(mq, p[0]);
      lq = lq * expf(mq - mm) + p[1] * expf(p[0] - mm);
      mq = mm;
      h += p[2];
    }
    float* out = part + static_cast<size_t>(blockIdx.y) * 3 * n + row;
    out[0] = mq;
    out[n] = lq;
    out[2 * n] = h;
  }
}

// lse = M + log sum_s l_s exp(m_s - M) with M = max_s m_s, higher = sum_s h_s,
// in the order s = 0, 1, ...; target logit = scale * t.
__global__ void __launch_bounds__(kThreads)
fused_ce_fwd_combine_kernel(const float* __restrict__ part,
                            const float* __restrict__ t,
                            const float* __restrict__ scale,
                            float* __restrict__ lse, float* __restrict__ tlogit,
                            float* __restrict__ higher, int n, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float top = kNegInf;
  for (int s = 0; s < splits; ++s)
    top = fmaxf(top, part[static_cast<size_t>(s) * 3 * n + row]);
  float sum = 0.0f, h = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const float* p = part + static_cast<size_t>(s) * 3 * n + row;
    sum += p[n] * expf(p[0] - top);
    h += p[2 * n];
  }
  lse[row] = top + logf(sum);
  tlogit[row] = scale[row] * t[row];
  higher[row] = h;
}

// ---- bf16 split-C forward (fused_ce_fwd(_mem)_bf16) ----------------------
//
// The counterpart of _fwd_kernel with mm_dtype=bfloat16 (K5; with the blend
// its has_mem body). Three launches from one entry:
//   1. fused_ce_round_bf16_kernel rounds xn, wn (and memn) to bf16 once per
//      element into the workspace: xb [N][dp] and wb, mb [D][Cp], zero-padded
//      to dp = round16(D) and Cp = round8(C) columns, so that every row starts
//      on 16 bytes (C = 10,575 is odd) and the split kernel stages them with
//      16-byte cp.async copies;
//   2. fused_ce_fwd_bf16_split_kernel on a grid of 64-row tiles x class
//      ranges of whole 128-wide tiles (range_cols: two blocks per SM where
//      C allows) writes each range's (m, l, higher) per row into the fp32
//      forward's [S][3][N] layout;
//   3. fused_ce_fwd_combine_kernel merges them in range order.
// A block keeps its 64 rows of xb in shared memory and streams its range's
// wb (mb) in 32-deep chunks through a 4-stage cp.async ring, so one staged
// chunk feeds 64 rows. Eight warps (2 x 4) each own 32 rows x 32 classes of
// the 64 x 128 cosine tile: per 16-deep k step 2 ldmatrix.x4 of xb, 2
// ldmatrix.x4.trans of the chunk (with the blend 2 more) and 8 (16)
// mma.sync.m16n8k16 bf16 products with fp32 accumulators in registers. The
// blend, the clamp, the margin, the online logsumexp and `higher` run in
// fp32 on each thread's own accumulator elements (4 rows x 8 classes); the
// rows' partial (m, l, higher) meet over the 4 lanes of a quad by shuffles
// and over the 4 warps of a row half through shared memory, in a fixed
// order: no atomics, so two launches give bitwise-equal results. Rows past
// N are inert (load_row), columns past C masked.
// Bytes at N=512, D=512, C=10,575: the pre-pass reads 22.7 MB of fp32 (44.4
// MB with memn) and writes 11.4 MB of bf16 (22.2 MB); the split kernel reads
// 64 rows of xb (64 KB) and 2 tiles of wb per block from L2.

constexpr int kBfRows = 64;                     // rows of a block tile
constexpr int kBfCols = 128;                    // width of a class tile
constexpr int kBfDepth = 32;                    // D depth of one staged chunk
constexpr int kBfStages = 4;                    // cp.async ring
constexpr int kBfChunk = kBfDepth * kBfCols;    // bf16 elements of a chunk
static_assert(kBfDepth * kBfCols / 8 == 2 * kThreads,
              "two 16-byte copies a thread per staged chunk");

__host__ __device__ constexpr int round8(int c) { return (c + 7) & ~7; }

// Byte offsets in dynamic shared memory: the block's Row scalars
// [kBfRows], xs [kBfRows][dp + 8] bf16 (the pitch keeps ldmatrix's 8 rows
// on different banks), then the ring [kBfStages][kMem ? 2 : 1][kBfDepth]
// [kBfCols] bf16.
__host__ __device__ inline size_t fwd_bf16_xs_at() {
  return align128(sizeof(Row) * kBfRows);
}
__host__ __device__ inline size_t fwd_bf16_ring_at(int d) {
  return fwd_bf16_xs_at() +
         align128(sizeof(bf16) * kBfRows * (round16(d) + 8));
}
__host__ __device__ inline size_t fwd_bf16_smem(int d, bool mem) {
  return fwd_bf16_ring_at(d) +
         sizeof(bf16) * kBfStages * (mem ? 2 : 1) * kBfChunk;
}

// Float offsets in the workspace of a bf16 fwd or bwd_dx entry: `part`
// floats of fp32 partials (fwd [S][3][N]; bwd_dx dx_part_floats), then xb
// [N][dp], wb [D][Cp] and (mem) mb [D][Cp] bf16, each on 16 bytes.
struct BfWs {
  size_t xb, wb, mb, total;
};

// floats rounded up to 16 bytes
inline size_t on16(size_t floats) { return (floats + 3) & ~size_t{3}; }

inline BfWs bf16_ws(size_t part, int n, int d, int c, bool mem) {
  const size_t w = static_cast<size_t>(d) * round8(c) / 2;
  BfWs L;
  L.xb = on16(part);
  L.wb = on16(L.xb + static_cast<size_t>(n) * round16(d) / 2);
  L.mb = on16(L.wb + w);
  L.total = L.mb + (mem ? w : 0);
  return L;
}

// The bf16 bwd_dw's workspace: `part` floats of dw partials, then xb
// [N][dp] on 16 bytes.
inline size_t dw_bf16_xb(size_t part) { return on16(part); }
inline size_t dw_bf16_xb_floats(int n, int d) {
  return static_cast<size_t>(n) * round16(d) / 2;
}

// fp32 src [rows][cols] -> bf16 dst [rows][pitch] (round to nearest even),
// zero in columns cols .. pitch - 1; pitch is a multiple of 8. blockIdx.y
// picks the job; a thread writes 8 elements, one 16-byte store.
struct RoundJob {
  const float* src;
  bf16* dst;
  int rows, cols, pitch;
};
struct RoundJobs {
  RoundJob job[3];
};

__global__ void __launch_bounds__(kThreads)
fused_ce_round_bf16_kernel(const RoundJobs jobs) {
  // a constant index each: a dynamic one would copy the jobs to the stack
  const RoundJob jb = blockIdx.y == 0   ? jobs.job[0]
                      : blockIdx.y == 1 ? jobs.job[1]
                                        : jobs.job[2];
  const int per_row = jb.pitch / 8;
  const size_t groups = static_cast<size_t>(jb.rows) * per_row;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < groups; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = i / per_row;
    const int j0 = static_cast<int>(i - r * per_row) * 8;
    const float* src = jb.src + r * jb.cols;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = __float2bfloat16_rn(j0 + e < jb.cols ? src[j0 + e] : 0.0f);
    *reinterpret_cast<uint4*>(jb.dst + r * jb.pitch + j0) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// The bf16 forward over one class range into part [S][3][N] (see above).
// Without the blend two blocks share an SM (101,888 B of shared memory at
// D = 512); with it one (134,656 B).
template <bool kMem>
__global__ void __launch_bounds__(kThreads, kMem ? 1 : 2)
fused_ce_fwd_bf16_split_kernel(const bf16* __restrict__ xb,
                               const bf16* __restrict__ wb,
                               const bf16* __restrict__ mb,
                               const float* __restrict__ lam,
                               const int* __restrict__ labels,
                               const float* __restrict__ t,
                               const float* __restrict__ tcos,
                               const float* __restrict__ scale,
                               const float* __restrict__ ab,
                               float* __restrict__ part, int n, int d, int c,
                               int range_cols, int mode, int has_clamp,
                               float clamp_eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int kOps = kMem ? 2 : 1;
  constexpr int kTileChunks = kBfCols / 8;   // 16-byte chunks of a chunk row
  const int dp = round16(d);
  const int cp = round8(c);
  const int xpitch = dp + 8;
  Row* rows = reinterpret_cast<Row*>(smem_raw);
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + fwd_bf16_xs_at());
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + fwd_bf16_ring_at(d));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wr = (warp >> 2) * 32;   // the warp's rows of the tile
  const int wc = (warp & 3) * 32;    // and its classes
  const int g = lane >> 2;
  const int qd = lane & 3;
  const int row0 = blockIdx.x * kBfRows;
  const int c_lo = blockIdx.y * range_cols;
  const int c_hi = min(c, c_lo + range_cols);
  const int nk = ceil_div(dp, kBfDepth);
  const int total = (c_hi > c_lo ? ceil_div(c_hi - c_lo, kBfCols) : 0) * nk;
  if (tid < kBfRows)
    rows[tid] = load_row(row0 + tid, n, labels, t, tcos, scale, ab, nullptr,
                         nullptr, nullptr);
  // the block's rows of xb ride in the first cp.async group; zero past N
  const int segs = dp / 8;
  for (int i = tid; i < kBfRows * segs; i += kThreads) {
    const int r = i / segs;
    const int sg = i - r * segs;
    const bool in = row0 + r < n;
    tc::cp_async16(xs + r * xpitch + sg * 8,
                   in ? xb + static_cast<size_t>(row0 + r) * dp + sg * 8 : xb,
                   in);
  }
  // a chunk of wb (mb): thread -> 16-byte chunk tid % 16 of rows
  // tid / 16 + 16 j; zero past D and past Cp
  const int seg = tid & 15;
  auto prefetch = [&](int i) {
    bf16* st = ring + (i % kBfStages) * kOps * kBfChunk;
    const int col = c_lo + (i / nk) * kBfCols + seg * 8;
    const int k0 = (i % nk) * kBfDepth;
#pragma unroll
    for (int j = 0; j < kBfDepth / 16; ++j) {
      const int kr = (tid >> 4) + 16 * j;
      const bool in = k0 + kr < d && col < cp;
      const size_t at = static_cast<size_t>(k0 + kr) * cp + col;
      const int to = tc::swz<kTileChunks>(kr, seg);
      tc::cp_async16(st + to, in ? wb + at : wb, in);
      if constexpr (kMem) tc::cp_async16(st + kBfChunk + to, in ? mb + at : mb, in);
    }
  };
  for (int i = 0; i < kBfStages - 1; ++i) {
    if (i < total) prefetch(i);
    tc::commit();
  }

  // the thread's rows wr + 16 mt + g + 8 h (q = 2 mt + h) and classes
  // c0 + wc + 8 nt + 2 qd + e of each class tile
  float acc[2][4][4], accm[2][4][4];
  float m[4], l[4], hi[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    m[q] = kNegInf;
    l[q] = 0.0f;
    hi[q] = 0.0f;
  }
  for (int i = 0; i < total; ++i) {
    tc::wait<kBfStages - 2>();
    __syncthreads();  // stage i landed; stage i - 1's readers done
    if (i + kBfStages - 1 < total) prefetch(i + kBfStages - 1);
    tc::commit();
    const int kc = i % nk;
    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = accm[mt][nt][e] = 0.0f;
    }
    const bf16* st = ring + (i % kBfStages) * kOps * kBfChunk;
    const int k0 = kc * kBfDepth;
    const int ksteps = min(kBfDepth, dp - k0) / 16;
#pragma unroll
    for (int ks = 0; ks < kBfDepth / 16; ++ks) {
      if (ks >= ksteps) break;
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        tc::ldmatrix_x4(af[mt], xs + (wr + 16 * mt + (lane & 15)) * xpitch +
                                    k0 + 16 * ks + 8 * (lane >> 4));
      // B fragments of the 4 n8 tiles of the warp's 32 classes, from the
      // chunk of wb (op 0) or mb (op 1)
      auto load_b = [&](int op, uint32_t bq[4][2]) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t r[4];
          tc::ldmatrix_x4_trans(
              r, st + op * kBfChunk +
                     tc::swz<kTileChunks>(16 * ks + (lane & 15),
                                          (wc >> 3) + 2 * jj + (lane >> 4)));
          bq[2 * jj][0] = r[0];
          bq[2 * jj][1] = r[1];
          bq[2 * jj + 1][0] = r[2];
          bq[2 * jj + 1][1] = r[3];
        }
      };
      uint32_t bq[4][2];
      load_b(0, bq);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          tc::mma_bf16(acc[mt][nt], af[mt], bq[nt][0], bq[nt][1]);
      if constexpr (kMem) {
        load_b(1, bq);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            tc::mma_bf16(accm[mt][nt], af[mt], bq[nt][0], bq[nt][1]);
      }
    }
    if (kc != nk - 1) continue;
    // the class tile is complete: blend, clamp, margin, online logsumexp and
    // `higher` on the thread's own elements
    const int c0 = c_lo + (i / nk) * kBfCols + wc + 2 * qd;
    if constexpr (kMem) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * nt + e;
          const float lt = col < c ? lam[col] : 0.0f;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              acc[mt][nt][2 * h + e] = (1.0f - lt) * acc[mt][nt][2 * h + e] +
                                       lt * accm[mt][nt][2 * h + e];
        }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int mt = q >> 1;
      const int h = q & 1;
      const Row& r = rows[wr + 16 * mt + g + 8 * h];
      float logit[8];
      float tile_max = kNegInf;
      float cnt = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * nt + e;
          float cs = acc[mt][nt][2 * h + e];  // blended with the memory's
          if (has_clamp)
            cs = fminf(fmaxf(cs, -1.0f + clamp_eps), 1.0f - clamp_eps);
          const bool in_range = col < c;
          const bool is_target = col == r.label;
          const float lg =
              in_range ? r.scale * (is_target ? r.t : h_fn(mode, cs, r.a, r.b))
                       : kNegInf;
          // pre-margin rank statistic for top-k accuracy (on the blended,
          // clamped cos): the target column never counts itself
          if (in_range && !is_target && cs > r.tcos) cnt += 1.0f;
          logit[2 * nt + e] = lg;
          tile_max = fmaxf(tile_max, lg);
        }
      const float m_new = fmaxf(m[q], tile_max);
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c0 + 8 * (j >> 1) + (j & 1) < c) s += expf(logit[j] - m_new);
      l[q] = l[q] * expf(m[q] - m_new) + s;
      m[q] = m_new;
      hi[q] += cnt;
    }
  }
  tc::wait<0>();

  // merge each row's (m, l, higher) over the quad's 4 lanes, then over the
  // 4 warps of its row half in order of warp
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[q], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[q], o);
      const float mm = fmaxf(m[q], mo);
      l[q] = l[q] * expf(m[q] - mm) + lo * expf(mo - mm);
      m[q] = mm;
      hi[q] += __shfl_xor_sync(0xffffffffu, hi[q], o);
    }
  }
  __syncthreads();  // the ring is free: red [4 warps][kBfRows][3]
  float* red = reinterpret_cast<float*>(ring);
  if (qd == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float* p = red + ((warp & 3) * kBfRows + wr + 16 * (q >> 1) + g +
                        8 * (q & 1)) * 3;
      p[0] = m[q];
      p[1] = l[q];
      p[2] = hi[q];
    }
  }
  __syncthreads();
  const int row = row0 + tid;
  if (tid < kBfRows && row < n) {
    float mq = kNegInf, lq = 0.0f, hq = 0.0f;
    for (int w = 0; w < 4; ++w) {
      const float* p = red + (w * kBfRows + tid) * 3;
      const float mm = fmaxf(mq, p[0]);
      lq = lq * expf(mq - mm) + p[1] * expf(p[0] - mm);
      mq = mm;
      hq += p[2];
    }
    float* out = part + static_cast<size_t>(blockIdx.y) * 3 * n + row;
    out[0] = mq;
    out[n] = lq;
    out[2 * n] = hq;
  }
}

// dx over one class range: dx_part [S][N][round4(D)] and the range's dt,
// dscale terms (without the direct path) row_part [S][2][N].
template <bool kMem>
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_bwd_dx_split_kernel(const float* __restrict__ xn,
                             const float* __restrict__ wn,
                             const float* __restrict__ memn,
                             const float* __restrict__ lam,
                             const int* __restrict__ labels,
                             const float* __restrict__ t,
                             const float* __restrict__ scale,
                             const float* __restrict__ ab,
                             const float* __restrict__ lse,
                             const float* __restrict__ g_lse,
                             float* __restrict__ dx_part,
                             float* __restrict__ row_part, int n, int d,
                             int c, int range_cols, int mode, int has_clamp,
                             float clamp_eps) {
  constexpr int nj = kSplitCols / kDxDepth;
  extern __shared__ float4 smem4[];
  Row* rows = reinterpret_cast<Row*>(smem4);
  float* ring = reinterpret_cast<float*>(rows + kDxRows);
  const int slot = split_slot(d, kMem, true);
  float* dct = ring + kStages * slot;          // dcos (* (1 - lam)) [j][row]
  float* dmt = dct + kSplitCols * kDxRows;  // kMem: dcos * lam
  const int r0 = cos_row0<kDxRows>();
  const int col0 = cos_col0();
  const int dr0 = 8 * ((threadIdx.x & 31) >> 3);  // dx rows and D columns
  const int dk0 = 64 * (threadIdx.x >> 5) + 4 * (threadIdx.x & 7);
  const bool dx_warp = 64 * (threadIdx.x >> 5) < d;
  const int row0 = blockIdx.x * kDxRows;
  int c_lo;
  const int nk = ceil_div(d, kDepth);
  const int per_tile = nk + nj;  // cosine stages, then dx stages
  const int total = range_tiles(c, range_cols, &c_lo) * per_tile;
  if (threadIdx.x < kDxRows)
    rows[threadIdx.x] = load_row(row0 + threadIdx.x, n, labels, t, nullptr,
                                 scale, ab, lse, g_lse, nullptr);

  auto prefetch = [&](int i) {
    float* sp = ring + (i % kStages) * slot;
    const int c0 = c_lo + (i / per_tile) * kSplitCols;
    const int sub = i % per_tile;
    if (sub < nk)
      stage_cos<kMem, kDxRows>(sp, xn, wn, memn, row0, n, d, c, c0,
                               sub * kDepth);
    else
      stage_dx<kMem>(sp, wn, memn, d, c, c0 + (sub - nk) * kDxDepth);
  };
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total) prefetch(i);
    cp_async_commit();
  }
  float acc[4][8], accm[4][8], dxa[8][8];
  float dt[4], dsc[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) dt[q] = dsc[q] = 0.0f;
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 8; ++e) dxa[q][e] = 0.0f;
  for (int i = 0; i < total; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i landed; stage i - 1's readers (and the
                      // dcos tiles' writers) done
    if (i + kStages - 1 < total) prefetch(i + kStages - 1);
    cp_async_commit();
    const float* sp = ring + (i % kStages) * slot;
    const int sub = i % per_tile;
    if (sub >= nk) {
      if (dx_warp)
        dx_stage<kMem>(dxa, sp, dct, dmt, (sub - nk) * kDxDepth, d, dr0, dk0);
      continue;
    }
    if (sub == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[q][e] = accm[q][e] = 0.0f;
    }
    cos_stage<kMem, kDxRows>(acc, accm, sp, r0, col0);
    if (sub != nk - 1) continue;
    // the cosine tile is complete: the thread's dcos into dct (and dmt),
    // read by every warp in the dx stages that follow
    const int c0 = c_lo + (i / per_tile) * kSplitCols;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int tc = elem_col(col0, e);
      const int col = c0 + tc;
      const float lt = kMem && col < c ? lam[col] : 0.0f;
      float g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float cs = acc[q][e];
        if constexpr (kMem) cs = (1.0f - lt) * cs + lt * accm[q][e];
        g[q] = dcos_of(cs, col, c, rows[r0 + q], mode, has_clamp, clamp_eps,
                       &dt[q], &dsc[q]);
      }
      float4* out = reinterpret_cast<float4*>(dct + tc * kDxRows + r0);
      if constexpr (kMem) {
        *out = make_float4(g[0] * (1.0f - lt), g[1] * (1.0f - lt),
                           g[2] * (1.0f - lt), g[3] * (1.0f - lt));
        *reinterpret_cast<float4*>(dmt + tc * kDxRows + r0) =
            make_float4(g[0] * lt, g[1] * lt, g[2] * lt, g[3] * lt);
      } else {
        *out = make_float4(g[0], g[1], g[2], g[3]);
      }
    }
  }
  cp_async_wait<0>();

  // dt, dscale of each row: over the 8 lanes of its row group, then over
  // the 4 warps of its row half (in order of warp)
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    dt[q] = sum8(dt[q]);
    dsc[q] = sum8(dsc[q]);
  }
  __syncthreads();  // the ring is free: [4 warps][32 rows][2]
  float* red = ring;
  const int wc = (threadIdx.x >> 5) & 3;
  if ((threadIdx.x & 7) == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      red[(wc * kDxRows + r0 + q) * 2] = dt[q];
      red[(wc * kDxRows + r0 + q) * 2 + 1] = dsc[q];
    }
  }
  __syncthreads();
  if (threadIdx.x < kDxRows && row0 + threadIdx.x < n) {
    float st = 0.0f, ss = 0.0f;
    for (int w = 0; w < 4; ++w) {
      st += red[(w * kDxRows + threadIdx.x) * 2];
      ss += red[(w * kDxRows + threadIdx.x) * 2 + 1];
    }
    float* p = row_part + static_cast<size_t>(blockIdx.y) * 2 * n + row0 +
               threadIdx.x;
    p[0] = st;
    p[n] = ss;
  }
  if (!dx_warp) return;
  const int dp = round4(d);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int row = row0 + dr0 + q;
    if (row >= n) continue;
    float* out = dx_part + (static_cast<size_t>(blockIdx.y) * n + row) * dp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = dk0 + 32 * h;
      if (k < d)
        *reinterpret_cast<float4*>(out + k) =
            make_float4(dxa[q][4 * h], dxa[q][4 * h + 1], dxa[q][4 * h + 2],
                        dxa[q][4 * h + 3]);
    }
  }
}

// dx = sum_s dx_part[s], dt and dscale = sum_s row_part[s] plus the direct
// path (target_logit = scale * t), in the order s = 0, 1, ...
__global__ void __launch_bounds__(kThreads)
fused_ce_bwd_dx_combine_kernel(const float* __restrict__ dx_part,
                               const float* __restrict__ row_part,
                               const float* __restrict__ t,
                               const float* __restrict__ scale,
                               const float* __restrict__ g_t,
                               float* __restrict__ dx, float* __restrict__ dt,
                               float* __restrict__ dscale, int n, int d,
                               int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(n) * d) return;
  const int row = static_cast<int>(i / d);
  const int k = static_cast<int>(i - static_cast<size_t>(row) * d);
  const size_t dp = round4(d);
  float sum = 0.0f;
  for (int s = 0; s < splits; ++s)
    sum += dx_part[(static_cast<size_t>(s) * n + row) * dp + k];
  dx[i] = sum;
  if (k == 0) {
    float st = 0.0f, ss = 0.0f;
    for (int s = 0; s < splits; ++s) {
      st += row_part[static_cast<size_t>(s) * 2 * n + row];
      ss += row_part[static_cast<size_t>(s) * 2 * n + n + row];
    }
    dt[row] = st + g_t[row] * scale[row];
    dscale[row] = ss + g_t[row] * t[row];
  }
}

// ---- bf16 split-C dx (fused_ce_bwd_dx(_mem)_bf16) ------------------------
//
// The counterpart of _bwd_dx_kernel and of the dx half of _bwd_fused_kernel
// with mm_dtype=bfloat16 (K5; with the blend their has_mem bodies). Three
// launches from one entry, as in the bf16 forward:
//   1. fused_ce_round_bf16_kernel rounds xn, wn (and memn) to bf16 once per
//      element into the workspace behind the partials (xb [N][dp], wb, mb
//      [D][Cp], rows on 16 bytes), so that every later copy is a 16-byte
//      cp.async;
//   2. fused_ce_bwd_dx_bf16_split_kernel on a grid of 32-row tiles x class
//      ranges of whole 128-wide tiles (range_cols: two blocks per SM where C
//      allows) writes each range's dx and (dt, dscale) in the fp32 dx's
//      partials layout, dx [S][N][round4(D)] then [S][2][N];
//   3. fused_ce_bwd_dx_combine_kernel sums them in range order: no atomics,
//      so two launches give bitwise-equal results.
// A block keeps its 32 rows of xb in shared memory and, per class tile, runs
// two products on mma.sync.m16n8k16 from one 4-stage ring of 16-byte copies:
//   - the cosines [32 rows][128 classes], over D in stages of 64 rows of wb
//     (and mb): eight warps as 2 (16 rows) x 4 (32 classes), ldmatrix of xb
//     and ldmatrix.trans of the stage, fp32 accumulators in registers;
//   - on those registers the blend, clamp, margin and dcos_of, with dt and
//     dscale summed per row in registers; bf16(dcos) (with the blend
//     bf16(dcos (1 - lam)) and bf16(dcos lam), each rounded on its own) goes
//     to a [32][128] shared tile, the A operand of
//   - dx += bf16(dcos) . wb[:, tile]^T over the tile's classes, in stages of
//     16 classes x all of D of wb (mb), read as [D][16] by plain ldmatrix:
//     warp w owns columns 64 w .. 64 w + 63 of D for all 32 rows, 64 fp32
//     accumulators a thread, held in registers for the block's whole range.
// wb is staged twice from L2 per class tile (once 64 deep for the cosines,
// once 16 wide for dx): 256 KB per 128-wide tile and block at D = 512, 512
// KB with mb. Keeping the [D][128] tile resident for both products would
// take 128 KB per operand and buffer, one block per SM without the blend
// and more than the SM holds with it.

constexpr int kBxRows = 32;      // rows of a block tile
constexpr int kBxCols = 128;     // width of a class tile
constexpr int kBxDepth = 64;     // D depth of one cosine stage
constexpr int kBxCls = 16;       // classes of one dx stage (one k step)
constexpr int kBxStages = 4;     // cp.async ring
constexpr int kBxDcPitch = kBxCols + 8;  // pitch of the dcos tile
static_assert(kBxDepth * kBxCols / 8 == 4 * kThreads,
              "four 16-byte copies a thread per cosine stage");
static_assert(kBxRows == 32 && kThreads == 256,
              "2 x 4 warps of 16 x 32 cosines; 8 warps x 64 columns of dx");

__host__ __device__ constexpr int round64(int d) { return (d + 63) & ~63; }

// Floats of the fp32 dx partials: dx [S][N][round4(D)], then (dt, dscale)
// [S][2][N], for the fp32 and the bf16 bwd_dx.
__host__ __device__ inline size_t dx_part_floats(int splits, int n, int d) {
  return static_cast<size_t>(splits) * n * (round4(d) + 2);
}

// bf16 elements of one operand's share of a ring slot: a cosine stage
// [kBxDepth][kBxCols] or a dx stage [round64(D)][kBxCls], the larger.
__host__ __device__ inline int dx_bf16_stage(int d) {
  const int cos = kBxDepth * kBxCols;
  const int dxs = round64(d) * kBxCls;
  return cos > dxs ? cos : dxs;
}

// Byte offsets in dynamic shared memory: the block's Row scalars
// [kBxRows], xs [kBxRows][dp + 8] bf16, the dcos tiles [kMem ? 2 : 1]
// [kBxRows][kBxDcPitch] bf16 (the pitches keep ldmatrix's 8 rows on
// different banks), then the ring [kBxStages][kMem ? 2 : 1][dx_bf16_stage].
__host__ __device__ inline size_t dx_bf16_xs_at() {
  return align128(sizeof(Row) * kBxRows);
}
__host__ __device__ inline size_t dx_bf16_dc_at(int d) {
  return dx_bf16_xs_at() +
         align128(sizeof(bf16) * kBxRows * (round16(d) + 8));
}
__host__ __device__ inline size_t dx_bf16_ring_at(int d, bool mem) {
  return dx_bf16_dc_at(d) +
         align128(sizeof(bf16) * (mem ? 2 : 1) * kBxRows * kBxDcPitch);
}
__host__ __device__ inline size_t dx_bf16_smem(int d, bool mem) {
  return dx_bf16_ring_at(d, mem) +
         sizeof(bf16) * kBxStages * (mem ? 2 : 1) * dx_bf16_stage(d);
}

// Element offset of half `h` (classes 8 h .. 8 h + 7) of row `r` of a dx
// stage [rows][kBxCls]: the halves swap in rows 4-7 of every 8, so the 8
// rows a plain ldmatrix reads at one half land on 8 different bank groups.
__device__ __forceinline__ int dx_stage_at(int r, int h) {
  return r * kBxCls + 8 * (h ^ ((r >> 2) & 1));
}

// dx over one class range (see above): dx_part [S][N][round4(D)] and the
// range's dt, dscale terms (without the direct path) row_part [S][2][N].
// Without the blend two blocks share an SM (108,800 B of shared memory at
// D = 512); with it one (183,040 B).
template <bool kMem>
__global__ void __launch_bounds__(kThreads, kMem ? 1 : 2)
fused_ce_bwd_dx_bf16_split_kernel(const bf16* __restrict__ xb,
                                  const bf16* __restrict__ wb,
                                  const bf16* __restrict__ mb,
                                  const float* __restrict__ lam,
                                  const int* __restrict__ labels,
                                  const float* __restrict__ t,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ ab,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ g_lse,
                                  float* __restrict__ dx_part,
                                  float* __restrict__ row_part, int n, int d,
                                  int c, int range_cols, int mode,
                                  int has_clamp, float clamp_eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int kOps = kMem ? 2 : 1;
  constexpr int kTileChunks = kBxCols / 8;  // 16-byte chunks of a tile row
  constexpr int nj = kBxCols / kBxCls;      // dx stages of a class tile
  const int dp = round16(d);
  const int cp = round8(c);
  const int xpitch = dp + 8;
  const int opsz = dx_bf16_stage(d);        // one operand's stage
  const int slot = kOps * opsz;
  const int dxr = round64(d);               // rows of a dx stage
  Row* rows = reinterpret_cast<Row*>(smem_raw);
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + dx_bf16_xs_at());
  bf16* dcs = reinterpret_cast<bf16*>(smem_raw + dx_bf16_dc_at(d));
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + dx_bf16_ring_at(d, kMem));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wr = (warp >> 2) * 16;   // the warp's rows of the cosine tile
  const int wc = (warp & 3) * 32;    // and its classes
  const int wd = warp * 64;          // its columns of D in the dx product
  const bool dx_warp = wd < d;
  const int g = lane >> 2;
  const int qd = lane & 3;
  const int row0 = blockIdx.x * kBxRows;
  const int c_lo = blockIdx.y * range_cols;
  const int c_hi = min(c, c_lo + range_cols);
  const int nk = ceil_div(dp, kBxDepth);
  const int per_tile = nk + nj;  // cosine stages, then dx stages
  const int total =
      (c_hi > c_lo ? ceil_div(c_hi - c_lo, kBxCols) : 0) * per_tile;
  if (tid < kBxRows)
    rows[tid] = load_row(row0 + tid, n, labels, t, nullptr, scale, ab, lse,
                         g_lse, nullptr);
  // the block's rows of xb ride in the first cp.async group; zero past N
  const int segs = dp / 8;
  for (int i = tid; i < kBxRows * segs; i += kThreads) {
    const int r = i / segs;
    const int sg = i - r * segs;
    const bool in = row0 + r < n;
    tc::cp_async16(xs + r * xpitch + sg * 8,
                   in ? xb + static_cast<size_t>(row0 + r) * dp + sg * 8 : xb,
                   in);
  }
  // stage i of the range: a cosine stage, wb[k0:k0+64, c0:c0+128] as
  // [64][128] (thread -> 16-byte chunk tid % 16 of rows tid / 16 + 16 j),
  // or a dx stage, wb[:, j0:j0+16] as [round64(D)][16]; zero past D and Cp
  auto prefetch = [&](int i) {
    bf16* st = ring + (i % kBxStages) * slot;
    const int c0 = c_lo + (i / per_tile) * kBxCols;
    const int sub = i % per_tile;
    if (sub < nk) {
      const int seg = tid & 15;
      const int col = c0 + seg * 8;
      const int k0 = sub * kBxDepth;
#pragma unroll
      for (int j = 0; j < kBxDepth / 16; ++j) {
        const int kr = (tid >> 4) + 16 * j;
        const bool in = k0 + kr < d && col < cp;
        const size_t at = static_cast<size_t>(k0 + kr) * cp + col;
        const int to = tc::swz<kTileChunks>(kr, seg);
        tc::cp_async16(st + to, in ? wb + at : wb, in);
        if constexpr (kMem)
          tc::cp_async16(st + opsz + to, in ? mb + at : mb, in);
      }
    } else {
      const int j0 = c0 + (sub - nk) * kBxCls;
      for (int e = tid; e < 2 * dxr; e += kThreads) {
        const int r = e >> 1;
        const int col = j0 + 8 * (e & 1);
        const bool in = r < d && col < cp;
        const size_t at = static_cast<size_t>(r) * cp + col;
        const int to = dx_stage_at(r, e & 1);
        tc::cp_async16(st + to, in ? wb + at : wb, in);
        if constexpr (kMem)
          tc::cp_async16(st + opsz + to, in ? mb + at : mb, in);
      }
    }
  };
  for (int i = 0; i < kBxStages - 1; ++i) {
    if (i < total) prefetch(i);
    tc::commit();
  }

  // cosines: the thread's rows wr + g + 8 h and classes wc + 8 nt + 2 qd + e
  // of the tile (acc[nt][2 h + e]); dx: rows 16 mt + g + 8 h and columns
  // wd + 8 nt + 2 qd + e of D (dxa[mt][nt][2 h + e])
  float acc[4][4], accm[4][4], dxa[2][8][4];
  float dt[2] = {0.0f, 0.0f}, dsc[2] = {0.0f, 0.0f};
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxa[mt][nt][e] = 0.0f;
  for (int i = 0; i < total; ++i) {
    tc::wait<kBxStages - 2>();
    __syncthreads();  // stage i landed; stage i - 1's readers (and the
                      // dcos tiles' writers) done
    if (i + kBxStages - 1 < total) prefetch(i + kBxStages - 1);
    tc::commit();
    const bf16* st = ring + (i % kBxStages) * slot;
    const int sub = i % per_tile;
    if (sub >= nk) {
      // dx += dcos[:, j:j+16] . stage^T over the stage's 16 classes
      if (!dx_warp) continue;
      const int j = (sub - nk) * kBxCls;
#pragma unroll
      for (int op = 0; op < kOps; ++op) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          tc::ldmatrix_x4(af[mt], dcs + (op * kBxRows + 16 * mt +
                                         (lane & 15)) * kBxDcPitch +
                                      j + 8 * (lane >> 4));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          // n8 tiles 2 np and 2 np + 1: lane l points at D row
          // wd + 16 np + l % 8 + 8 (l / 16), classes 8 ((l / 8) % 2) ..
          uint32_t b[4];
          tc::ldmatrix_x4(b, st + op * opsz +
                                 dx_stage_at(wd + 16 * np + (lane & 7) +
                                                 8 * (lane >> 4),
                                             (lane >> 3) & 1));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            tc::mma_bf16(dxa[mt][2 * np], af[mt], b[0], b[1]);
            tc::mma_bf16(dxa[mt][2 * np + 1], af[mt], b[2], b[3]);
          }
        }
      }
      continue;
    }
    if (sub == 0) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = accm[nt][e] = 0.0f;
    }
    const int k0 = sub * kBxDepth;
    const int ksteps = min(kBxDepth, dp - k0) / 16;
#pragma unroll
    for (int ks = 0; ks < kBxDepth / 16; ++ks) {
      if (ks >= ksteps) break;
      uint32_t af[4];
      tc::ldmatrix_x4(af, xs + (wr + (lane & 15)) * xpitch + k0 + 16 * ks +
                              8 * (lane >> 4));
      // B fragments of the 4 n8 tiles of the warp's 32 classes, from the
      // stage of wb (op 0) or mb (op 1)
      auto load_b = [&](int op, uint32_t bq[4][2]) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t r[4];
          tc::ldmatrix_x4_trans(
              r, st + op * opsz +
                     tc::swz<kTileChunks>(16 * ks + (lane & 15),
                                          (wc >> 3) + 2 * jj + (lane >> 4)));
          bq[2 * jj][0] = r[0];
          bq[2 * jj][1] = r[1];
          bq[2 * jj + 1][0] = r[2];
          bq[2 * jj + 1][1] = r[3];
        }
      };
      uint32_t bq[4][2];
      load_b(0, bq);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        tc::mma_bf16(acc[nt], af, bq[nt][0], bq[nt][1]);
      if constexpr (kMem) {
        load_b(1, bq);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          tc::mma_bf16(accm[nt], af, bq[nt][0], bq[nt][1]);
      }
    }
    if (sub != nk - 1) continue;
    // the cosine tile is complete: blend, clamp, margin and dcos on the
    // thread's own elements; bf16(dcos) (with the blend its two shares)
    // into the dcos tiles, read by every warp in the dx stages that follow
    const int c0 = c_lo + (i / per_tile) * kBxCols;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int tcol = wc + 8 * nt + 2 * qd;
      float lt[2] = {0.0f, 0.0f};
      if constexpr (kMem) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          lt[e] = c0 + tcol + e < c ? lam[c0 + tcol + e] : 0.0f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const Row& r = rows[wr + g + 8 * h];
        float gv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float cs = acc[nt][2 * h + e];
          if constexpr (kMem)
            cs = (1.0f - lt[e]) * cs + lt[e] * accm[nt][2 * h + e];
          gv[e] = dcos_of(cs, c0 + tcol + e, c, r, mode, has_clamp,
                          clamp_eps, &dt[h], &dsc[h]);
        }
        auto* out = reinterpret_cast<__nv_bfloat162*>(
            dcs + (wr + g + 8 * h) * kBxDcPitch + tcol);
        if constexpr (kMem) {
          out[0] = __floats2bfloat162_rn(gv[0] * (1.0f - lt[0]),
                                         gv[1] * (1.0f - lt[1]));
          out[kBxRows * kBxDcPitch / 2] =
              __floats2bfloat162_rn(gv[0] * lt[0], gv[1] * lt[1]);
        } else {
          out[0] = __floats2bfloat162_rn(gv[0], gv[1]);
        }
      }
    }
  }
  tc::wait<0>();

  // dt, dscale of each row: over the quad's 4 lanes, then over the 4 warps
  // of its row half (in order of warp)
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      dt[h] += __shfl_xor_sync(0xffffffffu, dt[h], o);
      dsc[h] += __shfl_xor_sync(0xffffffffu, dsc[h], o);
    }
  __syncthreads();  // the ring is free: [4 warps][kBxRows][2]
  float* red = reinterpret_cast<float*>(ring);
  if (qd == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* p = red + ((warp & 3) * kBxRows + wr + g + 8 * h) * 2;
      p[0] = dt[h];
      p[1] = dsc[h];
    }
  }
  __syncthreads();
  if (tid < kBxRows && row0 + tid < n) {
    float sdt = 0.0f, sds = 0.0f;
    for (int w = 0; w < 4; ++w) {
      sdt += red[(w * kBxRows + tid) * 2];
      sds += red[(w * kBxRows + tid) * 2 + 1];
    }
    float* p = row_part + static_cast<size_t>(blockIdx.y) * 2 * n + row0 + tid;
    p[0] = sdt;
    p[n] = sds;
  }
  if (!dx_warp) return;
  const int pitch = round4(d);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * mt + g + 8 * h;
      if (row >= n) continue;
      float* out = dx_part + (static_cast<size_t>(blockIdx.y) * n + row) *
                                 pitch;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int k = wd + 8 * nt + 2 * qd;
        const float v0 = dxa[mt][nt][2 * h];
        const float v1 = dxa[mt][nt][2 * h + 1];
        if (k + 1 < d)
          *reinterpret_cast<float2*>(out + k) = make_float2(v0, v1);
        else if (k < d)
          out[k] = v0;
      }
    }
}

// ---- fp32 dw: class tiles x row ranges (see the note at the head) -------
//
// Thread layout of the cosine tile [kDwRows rows][kDwCols classes]: warp w
// covers rows 32 w .. + 31; lane l rows 4 (8 w + l / 4) + {0..3} and classes
// 4 (l % 4) + {0..3, 16..19}, so a k step reads 128 B of xn^T and 2 x 64 B
// of wn per warp (broadcast across lanes) for 32 FMAs a lane. The dw tile
// [D][kDwCols], the mirror of bwd_dx's dx tile: warp w covers D columns
// 64 w .. + 63; lane l classes 8 (l / 8) .. + 7 and columns 4 (l % 8) +
// {0..3, 32..35}.

constexpr int kDwRows = 256;   // rows of a dw row tile (4 a thread)
constexpr int kDwDepth = 8;    // rows of one dw stage
// dcos tile [row][class]: +4 puts the epilogue's float4 stores of a lane's
// two neighbouring row groups on different banks
constexpr int kDctPitch = kDwCols + 4;
constexpr int kDwsPitch = kDwCols + 1;  // the final dw tile [k][class]
static_assert(kDwRows * kDwCols == 32 * kThreads, "4 x 8 cosines a thread");

// Floats of one ring slot of bwd_dw: a cosine stage (xn^T [kDepth]
// [xs_pitch(kDwRows)], wn [kDepth][kDwCols], with kMem memn too) or a dw
// stage (xn [kDwDepth][dx_pitch]), whichever is larger.
__host__ __device__ inline int dw_slot(int d, bool mem) {
  const int cos = kDepth * xs_pitch(kDwRows) + (mem ? 2 : 1) * kDepth * kDwCols;
  const int rows = kDwDepth * dx_pitch(d);
  return cos > rows ? cos : rows;
}

// Bytes: the ring and the dcos tile [kDwRows][kDctPitch]. The final dw tile
// [D][kDwsPitch] reuses both.
__host__ __device__ inline size_t dw_split_smem(int d, bool mem) {
  return sizeof(float) * (kStages * static_cast<size_t>(dw_slot(d, mem)) +
                          kDwRows * kDctPitch);
}
static_assert(kStages * (kDepth * xs_pitch(kDwRows) + kDepth * kDwCols) +
                      kDwRows * kDctPitch >=
                  kMaxSplitD * kDwsPitch,
              "the final dw tile fits in the ring and the dcos tile");

// Stage the cosine operands of the row tile at row0, depth d0: xn^T as in
// stage_cos and wn[d0:d0+16, c0:c0+32] into ws [kDepth][kDwCols] (kMem:
// memn into ms beside it), zero past D and C; a warp reads one row of the
// class tile per k.
template <bool kMem>
__device__ __forceinline__ void stage_dw_cos(float* slot, const float* xn,
                                             const float* wn,
                                             const float* memn, int row0,
                                             int n, int d, int c, int c0,
                                             int d0) {
  float* ws = slot + kDepth * xs_pitch(kDwRows);
  float* ms = ws + kDepth * kDwCols;
  stage_xt<kDwRows>(slot, xn, row0, n, d, d0);
#pragma unroll
  for (int it = 0; it < kDepth * kDwCols / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int k = i / kDwCols;
    const int j = i % kDwCols;
    const bool in = d0 + k < d && c0 + j < c;
    const size_t at = static_cast<size_t>(d0 + k) * c + c0 + j;
    cp_async4(ws + i, in ? wn + at : wn, in);
    if constexpr (kMem) cp_async4(ms + i, in ? memn + at : memn, in);
  }
}

// Stage rows [row0, row0 + kDwDepth) of xn into xr [kDwDepth][dx_pitch],
// zero past N; columns of D past d are left as they are (the dw
// accumulators they feed are never stored). Consecutive lanes read
// consecutive floats of a row.
__device__ __forceinline__ void stage_dw_rows(float* xr, const float* xn,
                                              int row0, int n, int d) {
  const int pitch = dx_pitch(d);
#pragma unroll
  for (int r = 0; r < kDwDepth; ++r) {
    const bool in = row0 + r < n;
    const float* src = in ? xn + static_cast<size_t>(row0 + r) * d : xn;
    for (int k = threadIdx.x; k < d; k += kThreads)
      cp_async4(xr + r * pitch + k, src + (in ? k : 0), in);
  }
}

// One cosine stage of bwd_dw: kDepth steps of xn . wn (kMem: and xn . memn,
// sharing the xn operand) into the thread's 4 x 8 tiles; r0 / j0 are its
// first row and class.
template <bool kMem>
__device__ __forceinline__ void dw_cos_stage(float acc[4][8], float accm[4][8],
                                             const float* slot, int r0,
                                             int j0) {
  constexpr int kPitch = xs_pitch(kDwRows);
  const float* xs = slot;
  const float* ws = xs + kDepth * kPitch;
  const float* ms = ws + kDepth * kDwCols;
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    const float4 a[1] = {ld4(xs + k * kPitch + r0)};
    const float* w = ws + k * kDwCols + j0;
    fma_tile<1>(acc, a, ld4(w), ld4(w + 16));
    if constexpr (kMem) {
      const float* m = ms + k * kDwCols + j0;
      fma_tile<1>(accm, a, ld4(m), ld4(m + 16));
    }
  }
}

// One dw stage: dw[8 classes, 8 columns of D] += dcos[rows, classes]^T .
// xn[rows, columns] over the stage's kDwDepth rows (rows rt0 .. of the
// dcos tile); j0 / k0 are the thread's first class and D column.
__device__ __forceinline__ void dw_stage(float dwa[8][8], const float* xr,
                                         const float* dct, int rt0, int pitch,
                                         int j0, int k0) {
#pragma unroll
  for (int rr = 0; rr < kDwDepth; ++rr) {
    const float* g = dct + (rt0 + rr) * kDctPitch + j0;
    const float4 a[2] = {ld4(g), ld4(g + 4)};
    const float* x = xr + rr * pitch + k0;
    fma_tile<2>(dwa, a, ld4(x), ld4(x + 32));
  }
}

// dw of one class tile over one row range, into out [S][D][C] (out is dw
// itself when S = 1). One block per SM: a thread's 64 dw accumulators and
// 32 cosine accumulators (64 with the blend) take most of its registers.
template <bool kMem>
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_bwd_dw_split_kernel(const float* __restrict__ xn,
                             const float* __restrict__ wn,
                             const float* __restrict__ memn,
                             const float* __restrict__ lam,
                             const int* __restrict__ labels,
                             const float* __restrict__ t,
                             const float* __restrict__ scale,
                             const float* __restrict__ ab,
                             const float* __restrict__ lse,
                             const float* __restrict__ g_lse,
                             float* __restrict__ out, int n, int d, int c,
                             int range_rows, int mode, int has_clamp,
                             float clamp_eps) {
  constexpr int nr = kDwRows / kDwDepth;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int slot = dw_slot(d, kMem);
  float* dct = ring + kStages * slot;  // dcos (* (1 - lam)) [row][class]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = 4 * (8 * warp + (lane >> 2));  // cosine rows and classes
  const int j0 = 4 * (lane & 3);
  const int dj0 = 8 * (lane >> 3);  // dw classes and D columns
  const int dk0 = 64 * warp + 4 * (lane & 7);
  const bool dw_warp = 64 * warp < d;
  const int c0 = blockIdx.x * kDwCols;
  const int pitch = dx_pitch(d);
  // rows past the range's end are staged as zeros and given inert scalars
  const int r_lo = blockIdx.y * range_rows;
  const int r_hi = min(n, r_lo + range_rows);
  const int nk = ceil_div(d, kDepth);
  const int per_tile = nk + nr;  // cosine stages, then dw stages
  const int total =
      (r_hi > r_lo ? ceil_div(r_hi - r_lo, kDwRows) : 0) * per_tile;

  auto prefetch = [&](int i) {
    float* sp = ring + (i % kStages) * slot;
    const int row0 = r_lo + (i / per_tile) * kDwRows;
    const int sub = i % per_tile;
    if (sub < nk)
      stage_dw_cos<kMem>(sp, xn, wn, memn, row0, r_hi, d, c, c0,
                         sub * kDepth);
    else
      stage_dw_rows(sp, xn, row0 + (sub - nk) * kDwDepth, r_hi, d);
  };
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total) prefetch(i);
    cp_async_commit();
  }
  float acc[4][8], accm[4][8], dwa[8][8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 8; ++e) dwa[q][e] = 0.0f;
  for (int i = 0; i < total; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i landed; stage i - 1's readers (and the
                      // dcos tile's writers) done
    if (i + kStages - 1 < total) prefetch(i + kStages - 1);
    cp_async_commit();
    const float* sp = ring + (i % kStages) * slot;
    const int sub = i % per_tile;
    if (sub >= nk) {
      if (dw_warp)
        dw_stage(dwa, sp, dct, (sub - nk) * kDwDepth, pitch, dj0, dk0);
      continue;
    }
    if (sub == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[q][e] = accm[q][e] = 0.0f;
    }
    dw_cos_stage<kMem>(acc, accm, sp, r0, j0);
    if (sub != nk - 1) continue;
    // the cosine tile is complete: the thread's dcos into dct, read by every
    // warp in the dw stages that follow
    const int row0 = r_lo + (i / per_tile) * kDwRows;
    float lt[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = c0 + j0 + (e & 3) + 16 * (e >> 2);
      lt[e] = kMem && col < c ? lam[col] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const Row r = load_row(row0 + r0 + q, r_hi, labels, t, nullptr, scale,
                             ab, lse, g_lse, nullptr);
      float unused_dt = 0.0f, unused_dsc = 0.0f;
      float g[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float cs = acc[q][e];
        if constexpr (kMem) cs = (1.0f - lt[e]) * cs + lt[e] * accm[q][e];
        g[e] = dcos_of(cs, c0 + j0 + (e & 3) + 16 * (e >> 2), c, r, mode,
                       has_clamp, clamp_eps, &unused_dt, &unused_dsc);
        // only the weight-cosine share reaches W
        if constexpr (kMem) g[e] *= 1.0f - lt[e];
      }
      float* o = dct + (r0 + q) * kDctPitch + j0;
      *reinterpret_cast<float4*>(o) = make_float4(g[0], g[1], g[2], g[3]);
      *reinterpret_cast<float4*>(o + 16) = make_float4(g[4], g[5], g[6], g[7]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring and the dcos tile are free: dw [D][kDwsPitch]
  float* dws = ring;
  if (dw_warp) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = dk0 + (e & 3) + 32 * (e >> 2);
        if (k < d) dws[k * kDwsPitch + dj0 + q] = dwa[q][e];
      }
  }
  __syncthreads();
  if (c0 + lane >= c) return;
  float* o = out + static_cast<size_t>(blockIdx.y) * d * c + c0 + lane;
  for (int k = warp; k < d; k += kThreads / 32)
    o[static_cast<size_t>(k) * c] = dws[k * kDwsPitch + lane];
}

// dw = sum_s part[s], in the order s = 0, 1, ...
__global__ void __launch_bounds__(kThreads)
fused_ce_bwd_dw_combine_kernel(const float* __restrict__ part,
                               float* __restrict__ dw, size_t elems,
                               int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= elems) return;
  float sum = 0.0f;
  for (int s = 0; s < splits; ++s) sum += part[s * elems + i];
  dw[i] = sum;
}

// ---- bf16 dw: class tiles x row ranges (fused_ce_bwd_dw(_mem)_bf16) -----
//
// The counterpart of _bwd_dw_kernel and of the dw half of _bwd_fused_kernel
// with mm_dtype=bfloat16 (K5; with the blend their has_mem bodies):
//   dw = bf16(xn)^T . bf16(dcos (* (1 - lam))), fp32 accumulation.
// Two launches from one entry, three where it runs more than one row range:
//   1. fused_ce_round_bf16_kernel rounds xn to bf16 once into the workspace
//      (xb [N][dp], dp = round16(D), behind any dw partials). wn and memn
//      are not pre-rounded: each class tile of them is read by one block
//      only, so a pre-pass would add bytes to a kernel bound by them;
//   2. fused_ce_bwd_dw_bf16_split_kernel on a grid of 32-wide class tiles x
//      row ranges of whole row tiles (32 rows; 16 with the blend;
//      range_rows: two blocks per SM where N allows, one range at the
//      training shape) writes dw, or the range's dw partials [S][D][C];
//   3. with S > 1, fused_ce_bwd_dw_combine_kernel sums them in range order:
//      no atomics, so two launches give bitwise-equal dw.
// A block rounds its [D][32] tile of wn (and memn) to bf16 as it loads it,
// once, and warp w keeps its slice of D (columns 64 w .. 64 w + 63) of that
// tile as mma.sync.m16n8k16 B fragments in registers for the whole kernel,
// with the same slice of dw [64][32] as 64 fp32 accumulators. Only xb
// streams, in row tiles through a 4-stage ring of 16-byte cp.async copies;
// each staged tile feeds both products. Per row tile:
//   - each warp forms the partial cosines [rows][32] over its D slice (A by
//     ldmatrix of the staged tile) and stores them to a [8][rows][32] fp32
//     tile; the partials are summed in warp order, and the blend, clamp,
//     margin and dcos_of run on the sums, two classes of a row a thread per
//     16 rows; bf16(dcos (* (1 - lam))) goes to a [rows][32] tile;
//   - each warp adds xs^T . dcos into its dw slice: A by ldmatrix.trans of
//     the same staged tile, B by ldmatrix.trans of the dcos tile.
// The dw product of tile i runs after the cosines of tile i + 1, so one
// block barrier separates the partial cosines from their sum and one the
// dcos tile from its readers: two a tile. The loop's time goes to the
// latency of that chain more than to the products (on the H100, dropping
// either product moved the kernel by under 2%), so without the blend a tile
// holds 32 rows, halving the trips; with it, 16 (the second set of
// accumulators and partials would not fit). The dw slices leave through
// shared memory as coalesced 128-byte rows of C. Rows past the range's end
// are staged as zeros and given inert scalars; a warp whose slice lies past
// D has no products and its partials are not summed.
// Bytes at N=512, D=512, C=10,575: wn (memn) read once from device memory,
// dw written once (43 MB); xb (0.5 MB) read from L2 by every block, 174 MB
// in all.

constexpr int kBwStages = 4;             // cp.async ring
constexpr int kBwAhead = kBwStages - 2;  // tiles copied ahead of the one in use
constexpr int kBwPitch = kDwCols + 8;    // pitch of the [.][32] tiles: 80 B
static_assert(kThreads == 256 && kDwCols == 32,
              "8 warps x 64 columns of D; 16 rows x 32 classes, two a thread");

// Rows of a streamed tile of xb.
__host__ __device__ constexpr int dw_bf16_rows(bool mem) {
  return mem ? 16 : 32;
}

// Byte offsets in dynamic shared memory (dp = round16(D), R rows a tile):
// the ring [kBwStages][R][dp + 8] bf16 at 0 (the pitch keeps ldmatrix's 8
// rows on different banks), the partial cosines [kMem ? 2 : 1][8][R]
// [kBwPitch] fp32, the dcos tile [R][kBwPitch] bf16, then the class tile
// of wn (memn beside it) [kMem ? 2 : 1][dp][kBwPitch] bf16. At the end the
// dw tile [D][kDwsPitch] fp32 reuses the buffer from 0.
struct DwBfLayout {
  size_t part, dcb, wt, total;
};

__host__ __device__ inline DwBfLayout dw_bf16_layout(int d, bool mem) {
  const int dp = round16(d);
  const int ops = mem ? 2 : 1;
  const int rows = dw_bf16_rows(mem);
  DwBfLayout L;
  L.part = align128(sizeof(bf16) * kBwStages * rows * (dp + 8));
  L.dcb = L.part + align128(sizeof(float) * ops * 8 * rows * kBwPitch);
  L.wt = L.dcb + align128(sizeof(bf16) * rows * kBwPitch);
  L.total = L.wt + ops * align128(sizeof(bf16) * dp * kBwPitch);
  const size_t dws = sizeof(float) * d * kDwsPitch;
  if (dws > L.total) L.total = dws;
  return L;
}

// dw of one class tile over one row range (see above), into out [S][D][C]
// (dw itself when S = 1). One block per SM: a thread holds 64 dw
// accumulators and 32 B registers (64 with the blend).
template <bool kMem>
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_bwd_dw_bf16_split_kernel(const bf16* __restrict__ xb,
                                  const float* __restrict__ wn,
                                  const float* __restrict__ memn,
                                  const float* __restrict__ lam,
                                  const int* __restrict__ labels,
                                  const float* __restrict__ t,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ ab,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ g_lse,
                                  float* __restrict__ out, int n, int d,
                                  int c, int range_rows, int mode,
                                  int has_clamp, float clamp_eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int kOps = kMem ? 2 : 1;
  constexpr int kRowsT = dw_bf16_rows(kMem);
  constexpr int kM = kRowsT / 16;  // m16 tiles of the cosines, k steps of dw
  constexpr int kPart = 8 * kRowsT * kBwPitch;  // floats of an op's partials
  const int dp = round16(d);
  const int xp = dp + 8;
  const DwBfLayout L = dw_bf16_layout(d, kMem);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  float* part = reinterpret_cast<float*>(smem_raw + L.part);
  bf16* dcb = reinterpret_cast<bf16*>(smem_raw + L.dcb);
  bf16* wt = reinterpret_cast<bf16*>(smem_raw + L.wt);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int qd = lane & 3;
  const int wd = 64 * warp;  // the warp's slice of D
  const int kst = max(0, min(4, (dp - wd) / 16));  // its 16-deep k steps
  const int nact = ceil_div(dp, 64);               // warps with a slice
  const int c0 = blockIdx.x * kDwCols;
  const int r_lo = blockIdx.y * range_rows;
  const int r_hi = min(n, r_lo + range_rows);
  const int tiles = r_hi > r_lo ? ceil_div(r_hi - r_lo, kRowsT) : 0;
  // the thread's row of 16 (of each 16 rows of a tile) in the copies and
  // the epilogue, and its two classes of it in the epilogue
  const int er = tid >> 4;
  const int ej = 2 * (tid & 15);

  // tile i of the range into slot i % kBwStages, zero past the range: 16
  // threads a row, 16 bytes each in turn
  const int segs = dp / 8;
  auto prefetch = [&](int i) {
#pragma unroll
    for (int h = 0; h < kM; ++h) {
      const int r = er + 16 * h;
      bf16* st = ring + ((i % kBwStages) * kRowsT + r) * xp;
      const int row = r_lo + i * kRowsT + r;
      const bool in = row < r_hi;
      const bf16* src = in ? xb + static_cast<size_t>(row) * dp : xb;
      for (int sg = tid & 15; sg < segs; sg += 16)
        tc::cp_async16(st + sg * 8, src + (in ? sg * 8 : 0), in);
    }
  };
  for (int i = 0; i < kBwAhead; ++i) {
    if (i < tiles) prefetch(i);
    tc::commit();
  }

  // the class tile of wn (memn) rounded to bf16 once, zero past D and C:
  // 16 threads a row of 32 classes, two each, 32 loads a thread in flight
  constexpr int kBatch = 16 / kOps;  // rows a thread loads before it stores
  for (int k0 = er; k0 < dp; k0 += 16 * kBatch) {
    float v[kBatch][kOps][2];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int k = k0 + 16 * q;
#pragma unroll
      for (int op = 0; op < kOps; ++op) {
        const float* src = (op ? memn : wn) + static_cast<size_t>(k) * c + c0;
        v[q][op][0] = k < d && c0 + ej < c ? src[ej] : 0.0f;
        v[q][op][1] = k < d && c0 + ej + 1 < c ? src[ej + 1] : 0.0f;
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int k = k0 + 16 * q;
      if (k >= dp) break;
#pragma unroll
      for (int op = 0; op < kOps; ++op)
        *reinterpret_cast<__nv_bfloat162*>(wt + (op * dp + k) * kBwPitch +
                                           ej) =
            __floats2bfloat162_rn(v[q][op][0], v[q][op][1]);
    }
  }
  float lc[2] = {0.0f, 0.0f};
  if constexpr (kMem) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      lc[e] = c0 + ej + e < c ? lam[c0 + ej + e] : 0.0f;
  }
  __syncthreads();

  // the warp's slice of the class tile as B fragments [op][k step][n8 tile]
  uint32_t bw[kOps][4][4][2];
#pragma unroll
  for (int op = 0; op < kOps; ++op)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t r[4] = {0u, 0u, 0u, 0u};
        if (ks < kst)
          tc::ldmatrix_x4_trans(
              r, wt + (op * dp + wd + 16 * ks + (lane & 15)) * kBwPitch +
                     16 * jj + 8 * (lane >> 4));
        bw[op][ks][2 * jj][0] = r[0];
        bw[op][ks][2 * jj][1] = r[1];
        bw[op][ks][2 * jj + 1][0] = r[2];
        bw[op][ks][2 * jj + 1][1] = r[3];
      }

  // dw rows wd + 16 mt + g + 8 h, classes 8 nt + 2 qd + e: dwa[mt][nt][2 h + e]
  float dwa[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dwa[mt][nt][e] = 0.0f;

  // dw += xs^T . dcos over the rows of tile i (its slot, the dcos tile)
  auto dw_step = [&](int i) {
    const bf16* xs = ring + (i % kBwStages) * kRowsT * xp;
    const int mat = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < kM; ++kk) {
      uint32_t bd[4][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t r[4];
        tc::ldmatrix_x4_trans(r, dcb + (16 * kk + (lane & 15)) * kBwPitch +
                                     16 * jj + 8 * (lane >> 4));
        bd[2 * jj][0] = r[0];
        bd[2 * jj][1] = r[1];
        bd[2 * jj + 1][0] = r[2];
        bd[2 * jj + 1][1] = r[3];
      }
      // A [16 of D][16 rows] is xs transposed: matrix l / 8 of the ldmatrix
      // holds rows 8 ((l / 8) / 2) .. + 7 and D columns 8 ((l / 8) % 2) ..
      // + 7 of the m16 tile
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt >= kst) break;
        uint32_t a[4];
        tc::ldmatrix_x4_trans(
            a, xs + (16 * kk + (lane & 7) + 8 * (mat >> 1)) * xp + wd +
                   16 * mt + 8 * (mat & 1));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          tc::mma_bf16(dwa[mt][nt], a, bd[nt][0], bd[nt][1]);
      }
    }
  };

  // the epilogue's row scalars, loaded a tile ahead
  Row rw_next[kM];
#pragma unroll
  for (int h = 0; h < kM; ++h)
    rw_next[h] = load_row(r_lo + er + 16 * h, r_hi, labels, t, nullptr, scale,
                          ab, lse, g_lse, nullptr);
  for (int i = 0; i < tiles; ++i) {
    tc::wait<kBwAhead - 1>();
    __syncthreads();  // tile i landed; the dcos tile of tile i - 1 written
    if (i + kBwAhead < tiles) prefetch(i + kBwAhead);
    tc::commit();
    Row rw[kM];
#pragma unroll
    for (int h = 0; h < kM; ++h) {
      rw[h] = rw_next[h];
      rw_next[h] = load_row(r_lo + (i + 1) * kRowsT + er + 16 * h, r_hi,
                            labels, t, nullptr, scale, ab, lse, g_lse,
                            nullptr);
    }
    // partial cosines of the tile's rows over the warp's slice of D
    const bf16* xs = ring + (i % kBwStages) * kRowsT * xp;
    float acc[kOps][kM][4][4];
#pragma unroll
    for (int op = 0; op < kOps; ++op)
#pragma unroll
      for (int mt = 0; mt < kM; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[op][mt][nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks >= kst) break;
#pragma unroll
      for (int mt = 0; mt < kM; ++mt) {
        uint32_t a[4];
        tc::ldmatrix_x4(a, xs + (16 * mt + (lane & 15)) * xp + wd + 16 * ks +
                               8 * (lane >> 4));
#pragma unroll
        for (int op = 0; op < kOps; ++op)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            tc::mma_bf16(acc[op][mt][nt], a, bw[op][ks][nt][0],
                         bw[op][ks][nt][1]);
      }
    }
    if (warp < nact) {
#pragma unroll
      for (int op = 0; op < kOps; ++op)
#pragma unroll
        for (int mt = 0; mt < kM; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            float* p = part + op * kPart +
                       (warp * kRowsT + 16 * mt + g) * kBwPitch + 8 * nt +
                       2 * qd;
            *reinterpret_cast<float2*>(p) =
                make_float2(acc[op][mt][nt][0], acc[op][mt][nt][1]);
            *reinterpret_cast<float2*>(p + 8 * kBwPitch) =
                make_float2(acc[op][mt][nt][2], acc[op][mt][nt][3]);
          }
    }
    if (i > 0) dw_step(i - 1);
    __syncthreads();  // the partials are in; the dcos tile's readers done
    // per 16 rows: the cosines summed in warp order, then the blend, clamp,
    // margin and dcos on two classes of one row
#pragma unroll
    for (int h = 0; h < kM; ++h) {
      const int r = er + 16 * h;
      float2 cs = make_float2(0.0f, 0.0f), cm = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        if (w >= nact) break;
        const float* p = part + (w * kRowsT + r) * kBwPitch + ej;
        const float2 v = *reinterpret_cast<const float2*>(p);
        cs.x += v.x;
        cs.y += v.y;
        if constexpr (kMem) {
          const float2 m = *reinterpret_cast<const float2*>(p + kPart);
          cm.x += m.x;
          cm.y += m.y;
        }
      }
      float gv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float cv = e ? cs.y : cs.x;
        if constexpr (kMem)
          cv = (1.0f - lc[e]) * cv + lc[e] * (e ? cm.y : cm.x);
        float unused_dt = 0.0f, unused_dsc = 0.0f;
        gv[e] = dcos_of(cv, c0 + ej + e, c, rw[h], mode, has_clamp,
                        clamp_eps, &unused_dt, &unused_dsc);
        // only the weight-cosine share reaches W
        if constexpr (kMem) gv[e] *= 1.0f - lc[e];
      }
      *reinterpret_cast<__nv_bfloat162*>(dcb + r * kBwPitch + ej) =
          __floats2bfloat162_rn(gv[0], gv[1]);
    }
  }
  tc::wait<0>();
  __syncthreads();  // the last dcos tile is written
  if (tiles > 0) dw_step(tiles - 1);
  __syncthreads();  // every read done: dw [D][kDwsPitch] over the buffer
  float* dws = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    if (mt >= kst) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = wd + 16 * mt + g + 8 * h;
      if (k >= d) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        dws[k * kDwsPitch + 8 * nt + 2 * qd] = dwa[mt][nt][2 * h];
        dws[k * kDwsPitch + 8 * nt + 2 * qd + 1] = dwa[mt][nt][2 * h + 1];
      }
    }
  }
  __syncthreads();
  if (c0 + lane >= c) return;
  float* o = out + static_cast<size_t>(blockIdx.y) * d * c + c0 + lane;
  for (int k = warp; k < d; k += kThreads / 32)
    o[static_cast<size_t>(k) * c] = dws[k * kDwsPitch + lane];
}

int sm_count() {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Columns per class range of the fp32 fwd (which 0, 3), bwd_dx (1, 4), the
// bf16 fwd (6, 9) or the bf16 bwd_dx (7, 10): whole class tiles (256 wide;
// the bf16 kernels' 128), as many per range as keep at least two blocks per
// SM (row tiles x ranges) where C allows it.
int range_cols(int which, int n, int c) {
  const bool bf16 = which >= 6;
  const bool dx = which % 3 == 1;
  const int tile = bf16 ? (dx ? kBxCols : kBfCols) : kSplitCols;
  const int rows = bf16 ? (dx ? kBxRows : kBfRows) : split_rows(dx);
  const int ctiles = ceil_div(c, tile);
  const int want = ceil_div(2 * sm_count(), ceil_div(n, rows));
  return (want >= ctiles ? 1 : ctiles / want) * tile;
}

// Rows per row range of the fp32 bwd_dw (which 2, 5) or the bf16 bwd_dw
// (8, 11): whole row tiles (256 rows; the bf16 kernels' 32, 16 with the
// blend), as many per range as keep at least two blocks per SM (class
// tiles x ranges) where N allows it.
int range_rows(int which, int n, int c) {
  const int tile = which >= 6 ? dw_bf16_rows(which >= 9) : kDwRows;
  const int rtiles = ceil_div(n, tile);
  const int want = ceil_div(2 * sm_count(), max(1, ceil_div(c, kDwCols)));
  return (want >= rtiles ? 1 : rtiles / want) * tile;
}

int num_splits(int c, int cols) { return c > 0 ? ceil_div(c, cols) : 1; }

// Workspace floats of the fp32 fwd (which 0, 3), bwd_dx (1, 4) and bwd_dw
// (2, 5) entries and of the bf16 ones (6-11): their partials and, for the
// bf16 entries, the operands rounded to bf16 behind them (bf16_ws; bwd_dw
// xb only, dw_bf16_xb). A bwd_dw of a single row range has no partials.
size_t workspace_floats(int which, int n, int d, int c) {
  const int k = which % 3;
  if (k == 2) {
    const size_t s = num_splits(n, range_rows(which, n, c));
    const size_t part = s > 1 ? s * d * c : 0;
    return which >= 6 ? dw_bf16_xb(part) + dw_bf16_xb_floats(n, d) : part;
  }
  const int s = num_splits(c, range_cols(which, n, c));
  const size_t part =
      k == 0 ? 3 * static_cast<size_t>(s) * n : dx_part_floats(s, n, d);
  return which >= 6 ? bf16_ws(part, n, d, c, which >= 9).total : part;
}

size_t smem_bytes(int which, int d) {
  const bool mem = which % 6 >= 3;
  const int k = which % 3;
  if (which >= 6)
    return k == 0   ? fwd_bf16_smem(d, mem)
           : k == 1 ? dx_bf16_smem(d, mem)
                    : dw_bf16_layout(d, mem).total;
  return k == 2 ? dw_split_smem(d, mem) : split_smem(d, mem, k == 1);
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// fused_ce_fwd(_mem), the counterpart of _fwd_kernel (K1; with the blend,
// its has_mem body, K4). Bound at N=512, D=512, C=10,575 by fp32 operations:
// 0.083 ms (fwd_mem 0.166 ms dense) at 67 TFLOP/s. The split kernel puts
// ceil(N / 64) x S blocks on the card, each sweeping one class range with
// 8 x 8 register tiles fed by cp.async; the combine merges the ranges'
// (m, l, higher) in order of range.
template <bool kMem>
int launch_fwd(const float* xn, const float* wn, const float* memn,
               const float* lam, const int* labels, const float* t,
               const float* tcos, const float* scale, const float* ab,
               float* lse, float* tlogit, float* higher, float* ws, int n,
               int d, int c, int mode, int has_clamp, float clamp_eps,
               void* stream) {
  const size_t smem = split_smem(d, kMem, false);
  auto* kernel = fused_ce_fwd_split_kernel<kMem>;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cols = range_cols(0, n, c);
  const int splits = num_splits(c, cols);
  const auto st = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(ceil_div(n, kFwdRows), splits), kThreads, smem, st>>>(
      xn, wn, memn, lam, labels, t, tcos, scale, ab, ws, n, d, c, cols, mode,
      has_clamp, clamp_eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_ce_fwd_combine_kernel<<<ceil_div(n, kThreads), kThreads, 0, st>>>(
      ws, t, scale, lse, tlogit, higher, n, splits);
  return static_cast<int>(cudaGetLastError());
}

// fused_ce_bwd_dx(_mem), the counterpart of the dx half of _bwd_fused_kernel
// (K2) and of _bwd_dx_kernel (K3a; with the blend their has_mem bodies,
// K4). Bound by fp32 operations: 0.166 ms (bwd_dx_mem 0.331 ms dense) at
// N=512, D=512, C=10,575. The split kernel puts ceil(N / 32) x S blocks on
// the card, each recomputing the cosines of its range and adding dcos . wn^T
// into a dx accumulator in registers; the combine sums the ranges' dx, dt
// and dscale in order of range.
template <bool kMem>
int launch_bwd_dx(const float* xn, const float* wn, const float* memn,
                  const float* lam, const int* labels, const float* t,
                  const float* scale, const float* ab, const float* lse,
                  const float* g_lse, const float* g_t, float* dx, float* dt,
                  float* dscale, float* ws, int n, int d, int c, int mode,
                  int has_clamp, float clamp_eps, void* stream) {
  if (d > kMaxSplitD) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = split_smem(d, kMem, true);
  auto* kernel = fused_ce_bwd_dx_split_kernel<kMem>;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cols = range_cols(1, n, c);
  const int splits = num_splits(c, cols);
  float* dx_part = ws;
  float* row_part = ws + static_cast<size_t>(splits) * n * round4(d);
  const auto st = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(ceil_div(n, kDxRows), splits), kThreads, smem, st>>>(
      xn, wn, memn, lam, labels, t, scale, ab, lse, g_lse, dx_part, row_part,
      n, d, c, cols, mode, has_clamp, clamp_eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t elems = static_cast<size_t>(n) * d;
  fused_ce_bwd_dx_combine_kernel<<<
      static_cast<unsigned>((elems + kThreads - 1) / kThreads), kThreads, 0,
      st>>>(dx_part, row_part, t, scale, g_t, dx, dt, dscale, n, d, splits);
  return static_cast<int>(cudaGetLastError());
}

// fused_ce_round_bf16_kernel on the first `njobs` jobs, `groups` 8-element
// groups in the largest.
cudaError_t launch_round(const RoundJobs& jobs, int njobs, long long groups,
                         cudaStream_t st) {
  const dim3 grid(
      static_cast<unsigned>(std::min<long long>(ceil_div(groups, kThreads),
                                                8LL * sm_count())),
      njobs);
  fused_ce_round_bf16_kernel<<<grid, kThreads, 0, st>>>(jobs);
  return cudaGetLastError();
}

// The bf16 fwd and dx entries' pre-pass: xn, wn (and memn) rounded to bf16
// once into the workspace at L (xb [N][dp], wb and mb [D][Cp], zero-padded).
cudaError_t round_bf16(const float* xn, const float* wn, const float* memn,
                       float* ws, const BfWs& L, int n, int d, int c,
                       bool mem, cudaStream_t st) {
  const RoundJobs jobs = {
      {{xn, reinterpret_cast<bf16*>(ws + L.xb), n, d, round16(d)},
       {wn, reinterpret_cast<bf16*>(ws + L.wb), d, c, round8(c)},
       {memn, reinterpret_cast<bf16*>(ws + L.mb), d, c, round8(c)}}};
  return launch_round(jobs, mem ? 3 : 2,
                      std::max(static_cast<long long>(n) * round16(d),
                               static_cast<long long>(d) * round8(c)) / 8,
                      st);
}

// fused_ce_fwd(_mem)_bf16, the counterpart of _fwd_kernel with
// mm_dtype=bfloat16 (K5; with the blend its has_mem body). Bound at N=512,
// D=512, C=10,575 by bytes: 0.0068 ms (0.0071 with memn at VPL's one-step
// lam) at 3.35 TB/s. The pre-pass rounds the operands to bf16 into the
// workspace, the split kernel puts ceil(N / 64) x S blocks on the card, the
// combine merges the ranges' (m, l, higher) in order of range.
template <bool kMem>
int launch_fwd_bf16(const float* xn, const float* wn, const float* memn,
                    const float* lam, const int* labels, const float* t,
                    const float* tcos, const float* scale, const float* ab,
                    float* lse, float* tlogit, float* higher, float* ws, int n,
                    int d, int c, int mode, int has_clamp, float clamp_eps,
                    void* stream) {
  const size_t smem = fwd_bf16_smem(d, kMem);
  auto* kernel = fused_ce_fwd_bf16_split_kernel<kMem>;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cols = range_cols(kMem ? 9 : 6, n, c);
  const int splits = num_splits(c, cols);
  const BfWs L = bf16_ws(3 * static_cast<size_t>(splits) * n, n, d, c, kMem);
  const auto st = static_cast<cudaStream_t>(stream);
  err = round_bf16(xn, wn, memn, ws, L, n, d, c, kMem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(ceil_div(n, kBfRows), splits), kThreads, smem, st>>>(
      reinterpret_cast<bf16*>(ws + L.xb), reinterpret_cast<bf16*>(ws + L.wb),
      reinterpret_cast<bf16*>(ws + L.mb), lam, labels, t, tcos, scale, ab, ws,
      n, d, c, cols, mode, has_clamp, clamp_eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_ce_fwd_combine_kernel<<<ceil_div(n, kThreads), kThreads, 0, st>>>(
      ws, t, scale, lse, tlogit, higher, n, splits);
  return static_cast<int>(cudaGetLastError());
}

// fused_ce_bwd_dx(_mem)_bf16, the counterpart of _bwd_dx_kernel and the dx
// half of _bwd_fused_kernel with mm_dtype=bfloat16 (K5; with the blend their
// has_mem bodies). Bound at N=512, D=512, C=10,575 by bf16 operations: two
// products, 4 N D C = 11.1 GFLOP, 0.0112 ms at 989 TFLOP/s (with memn on
// every class 0.0224 ms). The pre-pass rounds the operands to bf16 behind
// the partials, the split kernel puts ceil(N / 32) x S blocks on the card,
// the fp32 dx's combine sums the ranges' dx, dt and dscale in order of
// range.
template <bool kMem>
int launch_bwd_dx_bf16(const float* xn, const float* wn, const float* memn,
                       const float* lam, const int* labels, const float* t,
                       const float* scale, const float* ab, const float* lse,
                       const float* g_lse, const float* g_t, float* dx,
                       float* dt, float* dscale, float* ws, int n, int d,
                       int c, int mode, int has_clamp, float clamp_eps,
                       void* stream) {
  if (d > kMaxSplitD) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dx_bf16_smem(d, kMem);
  auto* kernel = fused_ce_bwd_dx_bf16_split_kernel<kMem>;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cols = range_cols(kMem ? 10 : 7, n, c);
  const int splits = num_splits(c, cols);
  const BfWs L = bf16_ws(dx_part_floats(splits, n, d), n, d, c, kMem);
  float* row_part = ws + static_cast<size_t>(splits) * n * round4(d);
  const auto st = static_cast<cudaStream_t>(stream);
  err = round_bf16(xn, wn, memn, ws, L, n, d, c, kMem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(ceil_div(n, kBxRows), splits), kThreads, smem, st>>>(
      reinterpret_cast<bf16*>(ws + L.xb), reinterpret_cast<bf16*>(ws + L.wb),
      reinterpret_cast<bf16*>(ws + L.mb), lam, labels, t, scale, ab, lse,
      g_lse, ws, row_part, n, d, c, cols, mode, has_clamp, clamp_eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t elems = static_cast<size_t>(n) * d;
  fused_ce_bwd_dx_combine_kernel<<<
      static_cast<unsigned>((elems + kThreads - 1) / kThreads), kThreads, 0,
      st>>>(ws, row_part, t, scale, g_t, dx, dt, dscale, n, d, splits);
  return static_cast<int>(cudaGetLastError());
}

// fused_ce_bwd_dw(_mem), the counterpart of the dw half of _bwd_fused_kernel
// (K2) and of _bwd_dw_kernel (K3b; with the blend their has_mem bodies,
// K4). Bound by fp32 operations: 0.166 ms (bwd_dw_mem 0.248 ms dense) at
// N=512, D=512, C=10,575. The split kernel puts ceil(C / 32) x S blocks on
// the card, each recomputing the cosines of its row range tile by tile and
// adding xn^T . dcos into a dw accumulator in registers; with S > 1 the
// combine sums the ranges' partials in order of range.
template <bool kMem>
int launch_bwd_dw(const float* xn, const float* wn, const float* memn,
                  const float* lam, const int* labels, const float* t,
                  const float* scale, const float* ab, const float* lse,
                  const float* g_lse, float* dw, float* ws, int n, int d,
                  int c, int mode, int has_clamp, float clamp_eps,
                  void* stream) {
  if (d > kMaxSplitD) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dw_split_smem(d, kMem);
  auto* kernel = fused_ce_bwd_dw_split_kernel<kMem>;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = range_rows(kMem ? 5 : 2, n, c);
  const int splits = num_splits(n, rows);
  const auto st = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(ceil_div(c, kDwCols), splits), kThreads, smem, st>>>(
      xn, wn, memn, lam, labels, t, scale, ab, lse, g_lse,
      splits > 1 ? ws : dw, n, d, c, rows, mode, has_clamp, clamp_eps);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t elems = static_cast<size_t>(d) * c;
  fused_ce_bwd_dw_combine_kernel<<<
      static_cast<unsigned>((elems + kThreads - 1) / kThreads), kThreads, 0,
      st>>>(ws, dw, elems, splits);
  return static_cast<int>(cudaGetLastError());
}

// fused_ce_bwd_dw(_mem)_bf16, the counterpart of _bwd_dw_kernel and the dw
// half of _bwd_fused_kernel with mm_dtype=bfloat16 (K5; with the blend
// their has_mem bodies). Bound at N=512, D=512, C=10,575 by bytes: wn read
// and dw written once, 43 MB, 0.0132 ms at 3.35 TB/s (memn adds what lam
// needs). The pre-pass rounds xn to bf16 behind any partials, the split
// kernel puts ceil(C / 32) x S blocks on the card, and with S > 1 the
// combine sums the ranges' partials in order of range.
template <bool kMem>
int launch_bwd_dw_bf16(const float* xn, const float* wn, const float* memn,
                       const float* lam, const int* labels, const float* t,
                       const float* scale, const float* ab, const float* lse,
                       const float* g_lse, float* dw, float* ws, int n, int d,
                       int c, int mode, int has_clamp, float clamp_eps,
                       void* stream) {
  if (d > kMaxSplitD) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dw_bf16_layout(d, kMem).total;
  auto* kernel = fused_ce_bwd_dw_bf16_split_kernel<kMem>;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = range_rows(kMem ? 11 : 8, n, c);
  const int splits = num_splits(n, rows);
  const size_t elems = static_cast<size_t>(d) * c;
  bf16* xb = reinterpret_cast<bf16*>(
      ws + dw_bf16_xb(splits > 1 ? splits * elems : 0));
  const auto st = static_cast<cudaStream_t>(stream);
  const RoundJobs jobs = {{{xn, xb, n, d, round16(d)}, {}, {}}};
  err = launch_round(jobs, 1, static_cast<long long>(n) * round16(d) / 8, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(ceil_div(c, kDwCols), splits), kThreads, smem, st>>>(
      xb, wn, memn, lam, labels, t, scale, ab, lse, g_lse,
      splits > 1 ? ws : dw, n, d, c, rows, mode, has_clamp, clamp_eps);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  fused_ce_bwd_dw_combine_kernel<<<
      static_cast<unsigned>((elems + kThreads - 1) / kThreads), kThreads, 0,
      st>>>(ws, dw, elems, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared-memory bytes each kernel needs at embedding width d; the wrapper
// refuses widths whose need exceeds the card's per-block limit. which: 0 fwd,
// 1 bwd_dx, 2 bwd_dw; 3, 4, 5 the same with the memory blend; 6-11 the bf16
// kernels in the same order.
size_t fused_ce_smem_bytes(int which, int d) { return smem_bytes(which, d); }

// Columns per class range of the split fwd (which 0, 3; bf16 6, 9) or
// bwd_dx (1, 4; bf16 7, 10) at (n, c) on the current device; the number of
// ranges is ceil(c / columns) (1 if c = 0).
int fused_ce_range_cols(int which, int n, int c) {
  return range_cols(which, n, c);
}

// Rows per row range of the fp32 bwd_dw (which 2, 5) or the bf16 bwd_dw
// (8, 11) at (n, c) on the current device; the number of ranges is
// ceil(n / rows) (1 if n = 0).
int fused_ce_dw_range_rows(int which, int n, int c) {
  return range_rows(which, n, c);
}

// Floats of the workspace the fp32 fwd (which 0, 3), bwd_dx (1, 4) or
// bwd_dw (2, 5) entry takes: fwd [S][3][N] (m, l, higher per range);
// bwd_dx [S][N][round4(D)] dx partials followed by [S][2][N] (dt, dscale
// without the direct path); bwd_dw [S][D][C] dw partials, none if S = 1.
// The bf16 entries (6-11) take the same partials followed by their
// operands rounded to bf16 (bwd_dw: xn only, as [N][round16(D)]).
size_t fused_ce_workspace_floats(int which, int n, int d, int c) {
  return workspace_floats(which, n, d, c);
}

// The combine launches alone, on partials laid out as in the workspace.
int fused_ce_fwd_combine(const float* part, const float* t,
                         const float* scale, float* lse, float* tlogit,
                         float* higher, int n, int splits, void* stream) {
  fused_ce_fwd_combine_kernel<<<ceil_div(n, kThreads), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      part, t, scale, lse, tlogit, higher, n, splits);
  return static_cast<int>(cudaGetLastError());
}

int fused_ce_bwd_dx_combine(const float* dx_part, const float* row_part,
                            const float* t, const float* scale,
                            const float* g_t, float* dx, float* dt,
                            float* dscale, int n, int d, int splits,
                            void* stream) {
  const size_t elems = static_cast<size_t>(n) * d;
  fused_ce_bwd_dx_combine_kernel<<<
      static_cast<unsigned>((elems + kThreads - 1) / kThreads), kThreads, 0,
      static_cast<cudaStream_t>(stream)>>>(dx_part, row_part, t, scale, g_t,
                                           dx, dt, dscale, n, d, splits);
  return static_cast<int>(cudaGetLastError());
}

int fused_ce_bwd_dw_combine(const float* part, float* dw, int d, int c,
                            int splits, void* stream) {
  const size_t elems = static_cast<size_t>(d) * c;
  fused_ce_bwd_dw_combine_kernel<<<
      static_cast<unsigned>((elems + kThreads - 1) / kThreads), kThreads, 0,
      static_cast<cudaStream_t>(stream)>>>(part, dw, elems, splits);
  return static_cast<int>(cudaGetLastError());
}

// IEEE fp32 entries. Each takes a workspace (fused_ce_workspace_floats)
// after its outputs and launches its split kernel and then its combine
// (bwd_dw: only when it runs more than one row range).
int fused_ce_fwd(const float* xn, const float* wn, const int* labels,
                 const float* t, const float* tcos, const float* scale,
                 const float* ab, float* lse, float* tlogit, float* higher,
                 float* ws, int n, int d, int c, int mode, int has_clamp,
                 float clamp_eps, void* stream) {
  return launch_fwd<false>(xn, wn, nullptr, nullptr, labels, t, tcos, scale,
                           ab, lse, tlogit, higher, ws, n, d, c, mode,
                           has_clamp, clamp_eps, stream);
}

int fused_ce_bwd_dx(const float* xn, const float* wn, const int* labels,
                    const float* t, const float* scale, const float* ab,
                    const float* lse, const float* g_lse, const float* g_t,
                    float* dx, float* dt, float* dscale, float* ws, int n,
                    int d, int c, int mode, int has_clamp, float clamp_eps,
                    void* stream) {
  return launch_bwd_dx<false>(xn, wn, nullptr, nullptr, labels, t, scale, ab,
                              lse, g_lse, g_t, dx, dt, dscale, ws, n, d, c,
                              mode, has_clamp, clamp_eps, stream);
}

int fused_ce_bwd_dw(const float* xn, const float* wn, const int* labels,
                    const float* t, const float* scale, const float* ab,
                    const float* lse, const float* g_lse, float* dw,
                    float* ws, int n, int d, int c, int mode, int has_clamp,
                    float clamp_eps, void* stream) {
  return launch_bwd_dw<false>(xn, wn, nullptr, nullptr, labels, t, scale, ab,
                              lse, g_lse, dw, ws, n, d, c, mode, has_clamp,
                              clamp_eps, stream);
}

int fused_ce_fwd_mem(const float* xn, const float* wn, const float* memn,
                     const float* lam, const int* labels, const float* t,
                     const float* tcos, const float* scale, const float* ab,
                     float* lse, float* tlogit, float* higher, float* ws,
                     int n, int d, int c, int mode, int has_clamp,
                     float clamp_eps, void* stream) {
  return launch_fwd<true>(xn, wn, memn, lam, labels, t, tcos, scale, ab, lse,
                          tlogit, higher, ws, n, d, c, mode, has_clamp,
                          clamp_eps, stream);
}

int fused_ce_bwd_dx_mem(const float* xn, const float* wn, const float* memn,
                        const float* lam, const int* labels, const float* t,
                        const float* scale, const float* ab, const float* lse,
                        const float* g_lse, const float* g_t, float* dx,
                        float* dt, float* dscale, float* ws, int n, int d,
                        int c, int mode, int has_clamp, float clamp_eps,
                        void* stream) {
  return launch_bwd_dx<true>(xn, wn, memn, lam, labels, t, scale, ab, lse,
                             g_lse, g_t, dx, dt, dscale, ws, n, d, c, mode,
                             has_clamp, clamp_eps, stream);
}

int fused_ce_bwd_dw_mem(const float* xn, const float* wn, const float* memn,
                        const float* lam, const int* labels, const float* t,
                        const float* scale, const float* ab, const float* lse,
                        const float* g_lse, float* dw, float* ws, int n,
                        int d, int c, int mode, int has_clamp,
                        float clamp_eps, void* stream) {
  return launch_bwd_dw<true>(xn, wn, memn, lam, labels, t, scale, ab, lse,
                             g_lse, dw, ws, n, d, c, mode, has_clamp,
                             clamp_eps, stream);
}

// bf16 tensor-core entries: the arguments of the fp32 ones, the workspace
// of fused_ce_workspace_floats (which 6-11) among them.
int fused_ce_fwd_bf16(const float* xn, const float* wn, const int* labels,
                      const float* t, const float* tcos, const float* scale,
                      const float* ab, float* lse, float* tlogit,
                      float* higher, float* ws, int n, int d, int c, int mode,
                      int has_clamp, float clamp_eps, void* stream) {
  return launch_fwd_bf16<false>(xn, wn, nullptr, nullptr, labels, t, tcos,
                                scale, ab, lse, tlogit, higher, ws, n, d, c,
                                mode, has_clamp, clamp_eps, stream);
}

int fused_ce_bwd_dx_bf16(const float* xn, const float* wn, const int* labels,
                         const float* t, const float* scale, const float* ab,
                         const float* lse, const float* g_lse,
                         const float* g_t, float* dx, float* dt,
                         float* dscale, float* ws, int n, int d, int c,
                         int mode, int has_clamp, float clamp_eps,
                         void* stream) {
  return launch_bwd_dx_bf16<false>(xn, wn, nullptr, nullptr, labels, t, scale,
                                   ab, lse, g_lse, g_t, dx, dt, dscale, ws, n,
                                   d, c, mode, has_clamp, clamp_eps, stream);
}

int fused_ce_bwd_dw_bf16(const float* xn, const float* wn, const int* labels,
                         const float* t, const float* scale, const float* ab,
                         const float* lse, const float* g_lse, float* dw,
                         float* ws, int n, int d, int c, int mode,
                         int has_clamp, float clamp_eps, void* stream) {
  return launch_bwd_dw_bf16<false>(xn, wn, nullptr, nullptr, labels, t,
                                   scale, ab, lse, g_lse, dw, ws, n, d, c,
                                   mode, has_clamp, clamp_eps, stream);
}

int fused_ce_fwd_mem_bf16(const float* xn, const float* wn, const float* memn,
                          const float* lam, const int* labels, const float* t,
                          const float* tcos, const float* scale,
                          const float* ab, float* lse, float* tlogit,
                          float* higher, float* ws, int n, int d, int c,
                          int mode, int has_clamp, float clamp_eps,
                          void* stream) {
  return launch_fwd_bf16<true>(xn, wn, memn, lam, labels, t, tcos, scale, ab,
                               lse, tlogit, higher, ws, n, d, c, mode,
                               has_clamp, clamp_eps, stream);
}

int fused_ce_bwd_dx_mem_bf16(const float* xn, const float* wn,
                             const float* memn, const float* lam,
                             const int* labels, const float* t,
                             const float* scale, const float* ab,
                             const float* lse, const float* g_lse,
                             const float* g_t, float* dx, float* dt,
                             float* dscale, float* ws, int n, int d, int c,
                             int mode, int has_clamp, float clamp_eps,
                             void* stream) {
  return launch_bwd_dx_bf16<true>(xn, wn, memn, lam, labels, t, scale, ab,
                                  lse, g_lse, g_t, dx, dt, dscale, ws, n, d,
                                  c, mode, has_clamp, clamp_eps, stream);
}

int fused_ce_bwd_dw_mem_bf16(const float* xn, const float* wn,
                             const float* memn, const float* lam,
                             const int* labels, const float* t,
                             const float* scale, const float* ab,
                             const float* lse, const float* g_lse, float* dw,
                             float* ws, int n, int d, int c, int mode,
                             int has_clamp, float clamp_eps, void* stream) {
  return launch_bwd_dw_bf16<true>(xn, wn, memn, lam, labels, t, scale, ab,
                                  lse, g_lse, dw, ws, n, d, c, mode,
                                  has_clamp, clamp_eps, stream);
}

}  // extern "C"
