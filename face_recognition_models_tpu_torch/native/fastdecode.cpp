// Native batch JPEG decoder for the host input pipeline. The port's copy of
// face_recognition_models_tpu/native/fastdecode.cpp, with the same C API.
//
// Decodes a whole batch with a C++ thread pool via libjpeg(-turbo),
// bilinear-resizes each image to the target square and writes straight into
// the caller's preallocated uint8 [N, H, W, 3] buffer. Python binds it with
// ctypes (native/fastdecode.py); it is host code, not a CUDA kernel.
//
// Exported C API:
//   int fd_decode_batch(const char** paths, int n,
//                       int out_size, unsigned char* out,
//                       int* status, int n_threads);
//     status[i]: 0 ok, nonzero = decode error (caller resamples).
//     returns number of failures.
//   int fd_decode_batch_mem(const unsigned char* blob,
//                           const long long* offsets,
//                           const long long* lengths, int n,
//                           int out_size, unsigned char* out,
//                           int* status, int n_threads);
//     same, decoding JPEG byte ranges of one in-memory blob (an mmap'd
//     RecordIO .rec file: offsets point at each record's image payload).

#include <cstdio>   // must precede jpeglib.h (it needs FILE)
#include <cstddef>

#include <jpeglib.h>

#include <atomic>
#include <csetjmp>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Bilinear resize RGB u8 HxW -> SxS.
void resize_bilinear(const unsigned char* src, int h, int w,
                     unsigned char* dst, int s) {
  const float sy = static_cast<float>(h) / s;
  const float sx = static_cast<float>(w) / s;
  for (int y = 0; y < s; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    float wy = fy - y0;
    for (int x = 0; x < s; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        float v00 = src[(y0 * w + x0) * 3 + c];
        float v01 = src[(y0 * w + x1) * 3 + c];
        float v10 = src[(y1 * w + x0) * 3 + c];
        float v11 = src[(y1 * w + x1) * 3 + c];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[(y * s + x) * 3 + c] = static_cast<unsigned char>(v + 0.5f);
      }
    }
  }
}

// Shared post-src decode: header -> scanlines -> resize into `out`.
// Caller owns create/destroy and the active setjmp; `full`/`row` scratch
// live in the caller's frame so a longjmp cannot leak them.
int decode_from_src(jpeg_decompress_struct* cinfo, int out_size,
                    unsigned char* out, std::vector<unsigned char>& full,
                    std::vector<unsigned char>& row) {
  if (jpeg_read_header(cinfo, TRUE) != JPEG_HEADER_OK) {
    return 1;
  }
  cinfo->out_color_space = JCS_RGB;
  // libjpeg can downscale by M/8 during decode — pick the smallest scale
  // that still covers the target (big win for large sources).
  jpeg_calc_output_dimensions(cinfo);
  unsigned int denom = 1;
  while (denom < 8 &&
         (cinfo->image_width / (denom * 2) >= (unsigned)out_size) &&
         (cinfo->image_height / (denom * 2) >= (unsigned)out_size)) {
    denom *= 2;
  }
  cinfo->scale_num = 1;
  cinfo->scale_denom = denom;
  jpeg_start_decompress(cinfo);

  const int w = cinfo->output_width;
  const int h = cinfo->output_height;
  const int comps = cinfo->output_components;
  full.resize(static_cast<size_t>(w) * h * 3);
  row.resize(static_cast<size_t>(w) * comps);
  for (int y = 0; y < h; ++y) {
    unsigned char* rp = row.data();
    jpeg_read_scanlines(cinfo, &rp, 1);
    unsigned char* dst = full.data() + static_cast<size_t>(y) * w * 3;
    if (comps == 3) {
      std::memcpy(dst, row.data(), static_cast<size_t>(w) * 3);
    } else {  // grayscale -> RGB
      for (int x = 0; x < w; ++x) {
        dst[x * 3] = dst[x * 3 + 1] = dst[x * 3 + 2] = row[x * comps];
      }
    }
  }
  jpeg_finish_decompress(cinfo);

  if (w == out_size && h == out_size) {
    std::memcpy(out, full.data(),
                static_cast<size_t>(out_size) * out_size * 3);
  } else {
    resize_bilinear(full.data(), h, w, out, out_size);
  }
  return 0;
}

// Decode one JPEG file to RGB u8 at out_size x out_size. Returns 0 on ok.
int decode_one(const char* path, int out_size, unsigned char* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 2;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;

  std::vector<unsigned char> full, row;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 1;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  int rc = decode_from_src(&cinfo, out_size, out, full, row);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return rc;
}

// Decode one in-memory JPEG buffer. Returns 0 on ok.
int decode_one_mem(const unsigned char* buf, unsigned long len,
                   int out_size, unsigned char* out) {
  if (len == 0) return 2;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;

  std::vector<unsigned char> full, row;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), len);
  int rc = decode_from_src(&cinfo, out_size, out, full, row);
  jpeg_destroy_decompress(&cinfo);
  return rc;
}

}  // namespace

extern "C" {

int fd_decode_batch(const char** paths, int n, int out_size,
                    unsigned char* out, int* status, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  const size_t stride = static_cast<size_t>(out_size) * out_size * 3;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int rc = decode_one(paths[i], out_size, out + stride * i);
      status[i] = rc;
      if (rc) failures.fetch_add(1);
    }
  };

  std::vector<std::thread> threads;
  int t = n_threads < n ? n_threads : n;
  threads.reserve(t);
  for (int i = 0; i < t; ++i) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failures.load();
}

int fd_decode_batch_mem(const unsigned char* blob, const long long* offsets,
                        const long long* lengths, int n, int out_size,
                        unsigned char* out, int* status, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  const size_t stride = static_cast<size_t>(out_size) * out_size * 3;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int rc = decode_one_mem(blob + offsets[i],
                              static_cast<unsigned long>(lengths[i]),
                              out_size, out + stride * i);
      status[i] = rc;
      if (rc) failures.fetch_add(1);
    }
  };

  std::vector<std::thread> threads;
  int t = n_threads < n ? n_threads : n;
  threads.reserve(t);
  for (int i = 0; i < t; ++i) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failures.load();
}

}  // extern "C"
