// 3x3, stride 1, SAME-padded NHWC convolution for Hopper (sm_90a), as an
// implicit GEMM.
//
// Counterpart of the Pallas kernel in face_recognition_models_tpu/ops/
// conv3x3.py (_kernel, :42, called through conv3x3_same at :83):
//   conv3x3_same_bf16 <- _kernel with bf16 x (the benchmarked case)
//   conv3x3_same_f32  <- _kernel with fp32 x
//
// Over the flattened rows r = n*H*W + h*W + w,
//   y[r, :] = sum_{a, b in {-1, 0, 1}} x[n, h + a, w + b, :] @ K[a + 1, b + 1]
// with x taken as 0 outside the image: a GEMM with M = N*H*W rows,
// N = C_out columns and K = 9*C, whose A operand is never materialised. The
// Pallas kernel rolls the flattened tile and masks the rows the roll wraps
// (a workaround for Mosaic's missing bf16 rotate); here each staged row
// computes its own source (h + a, w + b) and loads zeros where that falls
// outside the image.
//
// Design. A block of 256 threads computes a 64-row x 64-channel tile of y.
// It loops over the 9 taps x chunks of 32 input channels, staging into shared
// memory the masked, shifted rows of x ([64][32]) and the matching chunk of
// the weight ([32][64]). Each thread stages 8 consecutive channels of one row
// and 8 consecutive output channels of one weight row, so the row's
// (n, h, w) is decoded once per block.
//   - bf16: 8 warps, each a 16 x 32 part of the tile as two nvcuda::wmma
//     16x16x16 bf16 fragments with fp32 accumulators on the tensor cores;
//     the accumulators meet in an fp32 tile and leave rounded to bf16.
//   - fp32: IEEE fp32 FMAs on the CUDA cores (no TF32), each thread a 4 x 4
//     register tile.
// The accumulation is fp32 in both, over the taps in order (a, b) =
// (-1, -1), (-1, 0), ..., (1, 1) and then the channels; the output is in
// x's dtype. Forward only (the JAX kernel has no VJP).
//
// What bounds it: at the ResNet-50 stage shapes of the benchmark (batch 512:
// 28x28x128, 14x14x256, 7x7x512, C_out = C) each conv is 2*M*9*C*C_out =
// 118-119 GFLOP against 51-103 MB of bf16 x, y and weight, so it is bound by
// operations: 0.12 ms at 989 TFLOP/s dense bf16. This simple form stages
// with synchronous loads and runs wmma (no wgmma, TMA or pipelining), so it
// reaches a fraction of that.
//
// C interface: each entry launches on the given stream and returns
// cudaGetLastError(). x [N, H, W, C], w [9, C, C_out] (tap-major, the
// layout of K.reshape(9, C, C_out)) and y [N, H, W, C_out] are contiguous
// device arrays of the entry's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBM = 64;   // rows of y per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBK = 32;   // input channels per staged chunk
constexpr int kPadA = 8;  // bf16 row padding of the staged tiles

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
conv3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w9,
                    bf16* __restrict__ y, int n, int hh, int ww, int c,
                    int co) {
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
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w9,
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

}  // namespace

extern "C" {

int conv3x3_same_bf16(const void* x, const void* w9, void* y, int n, int h,
                      int w, int c, int co, void* stream) {
  return launch(conv3x3_bf16_kernel, static_cast<const bf16*>(x),
                static_cast<const bf16*>(w9), static_cast<bf16*>(y), n, h, w,
                c, co, stream);
}

int conv3x3_same_f32(const void* x, const void* w9, void* y, int n, int h,
                     int w, int c, int co, void* stream) {
  return launch(conv3x3_f32_kernel, static_cast<const float*>(x),
                static_cast<const float*>(w9), static_cast<float*>(y), n, h,
                w, c, co, stream);
}

}  // extern "C"
