// Fused margin + cross-entropy head for Hopper (sm_90a), IEEE fp32.
//
// Counterparts of the Pallas kernels in face_recognition_models_tpu/ops/
// fused_head.py:
//   fused_ce_fwd     <- _fwd_kernel        (K1)
//   fused_ce_bwd_dx  <- _bwd_fused_kernel's dx/dt/dscale half (K2), and
//                       _bwd_dx_kernel (K3a)
//   fused_ce_bwd_dw  <- _bwd_fused_kernel's dw half (K2), and
//                       _bwd_dw_kernel (K3b)
//
// Every head reduces to
//   logit[i, j]        = scale[i] * h(cos[i, j], a[i], b[i])   (j != label[i])
//   logit[i, label[i]] = scale[i] * t[i]
// with cos = xn @ wn, h one of three modes (identity, MV, curricular) and an
// optional clamp of cos to [-1 + eps, 1 - eps]. Columns >= C are masked and a
// label outside [0, C) marks no column as target (the class-sharded caller
// relies on that). The [N, C] logits never reach device memory.
//
// What bounds them: at the training shape (N=512, D=512, C=10,575) one
// product is 2*N*D*C = 5.5 GFLOP against ~22 MB of wn, so each kernel is
// bound by fp32 operations (67 TFLOP/s outside the tensor cores), not by
// bytes (3.35 TB/s). The products run in IEEE fp32 on the CUDA cores, never
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
// work.
//
// C interface: each entry launches on the given stream and returns
// cudaGetLastError() (0 on success). All pointers are device pointers to
// contiguous fp32 (labels int32) arrays; ab is [N, 2] with a = ab[:, 0],
// b = ab[:, 1]; wn and dw are [D, C] row-major.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 warps; warp w owns rows 2w and 2w + 1
constexpr int kRows = 16;       // rows per block tile
constexpr int kCols = 128;      // class-tile width of fwd / bwd_dx (4 per lane)
constexpr int kChunk = 32;      // depth of one W chunk staged in shared memory
constexpr int kDwCols = 32;     // class-tile width of bwd_dw (1 per lane)
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

// cos for the warp's two rows x the lane's four columns (lane + 32 * i) of
// the class tile starting at c0.
__device__ __forceinline__ void cos_tile(float acc[2][4], const float* xs,
                                         float* ws, const float* wn, int c0,
                                         int d, int c, int r0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[q][i] = 0.0f;
  for (int d0 = 0; d0 < d; d0 += kChunk) {
    __syncthreads();
    load_chunk(ws, wn, d0, c0, d, c);
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
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_ce_fwd_kernel(const float* __restrict__ xn, const float* __restrict__ wn,
                    const int* __restrict__ labels, const float* __restrict__ t,
                    const float* __restrict__ tcos,
                    const float* __restrict__ scale,
                    const float* __restrict__ ab, float* __restrict__ lse_out,
                    float* __restrict__ tlogit_out,
                    float* __restrict__ higher_out, int n, int d, int c,
                    int mode, int has_clamp, float clamp_eps) {
  extern __shared__ float smem[];
  float* xs = smem;                    // [kRows][d]
  float* ws = xs + kRows * d;          // [kChunk][kCols + 1]

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

  load_rows(xs, xn, row0, n, d);
  for (int c0 = 0; c0 < c; c0 += kCols) {
    float acc[2][4];
    cos_tile(acc, xs, ws, wn, c0, d, c, r0);
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
        // pre-margin rank statistic for top-k accuracy: the target column
        // never counts itself
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

__global__ void __launch_bounds__(kThreads)
fused_ce_bwd_dx_kernel(const float* __restrict__ xn,
                       const float* __restrict__ wn,
                       const int* __restrict__ labels,
                       const float* __restrict__ t,
                       const float* __restrict__ scale,
                       const float* __restrict__ ab,
                       const float* __restrict__ lse,
                       const float* __restrict__ g_lse,
                       const float* __restrict__ g_t, float* __restrict__ dx,
                       float* __restrict__ dt_out,
                       float* __restrict__ dscale_out, int n, int d, int c,
                       int mode, int has_clamp, float clamp_eps) {
  extern __shared__ float smem[];
  float* xs = smem;                        // [kRows][d]
  float* dxs = xs + kRows * d;             // [kRows][d] dx accumulator
  float* ws = dxs + kRows * d;             // [kChunk][kCols + 1]
  float* dcs = ws + kChunk * (kCols + 1);  // [kRows][kCols] dcos tile

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

  load_rows(xs, xn, row0, n, d);
  for (int i = threadIdx.x; i < kRows * d; i += kThreads) dxs[i] = 0.0f;

  for (int c0 = 0; c0 < c; c0 += kCols) {
    float acc[2][4];
    cos_tile(acc, xs, ws, wn, c0, d, c, r0);
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dcs[(r0 + q) * kCols + lane + 32 * i] =
            dcos_of(acc[q][i], c0 + lane + 32 * i, c, rp[q], mode, has_clamp,
                    clamp_eps, &dt[q], &dsc[q]);

    // dx[rows, d0 + lane] += dcos[rows, :] . wn[d0 + lane, tile]
    for (int d0 = 0; d0 < d; d0 += kChunk) {
      __syncthreads();  // dcs written; previous readers of ws done
      load_chunk(ws, wn, d0, c0, d, c);
      __syncthreads();
      float a0 = 0.0f, a1 = 0.0f;
      const float* wrow = ws + lane * (kCols + 1);
      const float* g0 = dcs + r0 * kCols;
      const float* g1 = g0 + kCols;
      for (int j = 0; j < kCols; ++j) {
        a0 = fmaf(g0[j], wrow[j], a0);
        a1 = fmaf(g1[j], wrow[j], a1);
      }
      if (d0 + lane < d) {
        dxs[r0 * d + d0 + lane] += a0;
        dxs[(r0 + 1) * d + d0 + lane] += a1;
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kRows * d; i += kThreads) {
    const int r = i / d;
    const int row = row0 + r;
    if (row < n) dx[static_cast<size_t>(row) * d + (i - r * d)] = dxs[i];
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
fused_ce_bwd_dw_kernel(const float* __restrict__ xn,
                       const float* __restrict__ wn,
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

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kDwCols;
  const int col = c0 + lane;
  const int r0 = 2 * warp;

  for (int i = threadIdx.x; i < d * kDwCols; i += kThreads) {
    const int k = i / kDwCols;
    const int j = i - k * kDwCols;
    wt[i] = c0 + j < c ? wn[static_cast<size_t>(k) * c + c0 + j] : 0.0f;
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
    float unused_dt = 0.0f, unused_dsc = 0.0f;
    const Row ra = load_row(row0 + r0, n, labels, t, nullptr, scale, ab, lse,
                            g_lse, nullptr);
    const Row rb = load_row(row0 + r0 + 1, n, labels, t, nullptr, scale, ab,
                            lse, g_lse, nullptr);
    dcs[r0 * kDwCols + lane] = dcos_of(acc0, col, c, ra, mode, has_clamp,
                                       clamp_eps, &unused_dt, &unused_dsc);
    dcs[(r0 + 1) * kDwCols + lane] = dcos_of(acc1, col, c, rb, mode,
                                             has_clamp, clamp_eps, &unused_dt,
                                             &unused_dsc);
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

size_t fwd_smem(int d) { return sizeof(float) * (kRows * d + kChunk * (kCols + 1)); }
size_t dx_smem(int d) {
  return sizeof(float) * (2 * kRows * d + kChunk * (kCols + 1) + kRows * kCols);
}
size_t dw_smem(int d) {
  return sizeof(float) * (2 * d * kDwCols + kRows * d + kRows * kDwCols);
}

}  // namespace

extern "C" {

// Shared-memory bytes each kernel needs at embedding width d; the wrapper
// refuses widths whose need exceeds the card's per-block limit.
size_t fused_ce_smem_bytes(int which, int d) {
  return which == 0 ? fwd_smem(d) : which == 1 ? dx_smem(d) : dw_smem(d);
}

int fused_ce_fwd(const float* xn, const float* wn, const int* labels,
                 const float* t, const float* tcos, const float* scale,
                 const float* ab, float* lse, float* tlogit, float* higher,
                 int n, int d, int c, int mode, int has_clamp, float clamp_eps,
                 void* stream) {
  const size_t smem = fwd_smem(d);
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kRows - 1) / kRows;
  fused_ce_fwd_kernel<<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      xn, wn, labels, t, tcos, scale, ab, lse, tlogit, higher, n, d, c, mode,
      has_clamp, clamp_eps);
  return static_cast<int>(cudaGetLastError());
}

int fused_ce_bwd_dx(const float* xn, const float* wn, const int* labels,
                    const float* t, const float* scale, const float* ab,
                    const float* lse, const float* g_lse, const float* g_t,
                    float* dx, float* dt, float* dscale, int n, int d, int c,
                    int mode, int has_clamp, float clamp_eps, void* stream) {
  const size_t smem = dx_smem(d);
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_bwd_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kRows - 1) / kRows;
  fused_ce_bwd_dx_kernel<<<blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      xn, wn, labels, t, scale, ab, lse, g_lse, g_t, dx, dt, dscale, n, d, c,
      mode, has_clamp, clamp_eps);
  return static_cast<int>(cudaGetLastError());
}

int fused_ce_bwd_dw(const float* xn, const float* wn, const int* labels,
                    const float* t, const float* scale, const float* ab,
                    const float* lse, const float* g_lse, float* dw, int n,
                    int d, int c, int mode, int has_clamp, float clamp_eps,
                    void* stream) {
  const size_t smem = dw_smem(d);
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (c + kDwCols - 1) / kDwCols;
  fused_ce_bwd_dw_kernel<<<blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      xn, wn, labels, t, scale, ab, lse, g_lse, dw, n, d, c, mode, has_clamp,
      clamp_eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
