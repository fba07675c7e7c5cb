// Native batch JPEG decoder + resizer for the training input pipeline.
//
// The reference feeds training from torchvision ImageFolder + DataLoader
// fork workers (helpers/loader.py:55-62) — native decode via PIL/libjpeg in
// worker processes. Here the host side of the training input pipeline
// decodes JPEG face crops with a C++ thread pool (libjpeg-turbo) and resizes
// with a fixed-point bilinear kernel, writing straight into a caller-provided
// batch buffer — no Python objects, no GIL, one memcpy-free pass.
//
// The port's own copy of fac_fake_tpu/native/decoder.cpp (the same code).
// Exposed C ABI (ctypes): see fac_fake_torch/data/native_loader.py.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  std::jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  std::longjmp(err->jump, 1);
}

// Bilinear resize (half-pixel centers), RGB u8 -> RGB u8.
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst,
                     int dh, int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    if (fy > sh - 1) fy = static_cast<float>(sh - 1);
    const int y0 = static_cast<int>(fy);
    const int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    const float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      if (fx > sw - 1) fx = static_cast<float>(sw - 1);
      const int x0 = static_cast<int>(fx);
      const int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      const float wx = fx - x0;
      const uint8_t* p00 = src + (y0 * sw + x0) * 3;
      const uint8_t* p01 = src + (y0 * sw + x1) * 3;
      const uint8_t* p10 = src + (y1 * sw + x0) * 3;
      const uint8_t* p11 = src + (y1 * sw + x1) * 3;
      uint8_t* out = dst + (y * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        const float top = p00[c] + (p01[c] - p00[c]) * wx;
        const float bot = p10[c] + (p11[c] - p10[c]) * wx;
        out[c] = static_cast<uint8_t>(top + (bot - top) * wy + 0.5f);
      }
    }
  }
}

// Decode one JPEG file to RGB u8. Returns true on success; fills (h, w) and
// the pixel vector.
bool decode_jpeg(const char* path, std::vector<uint8_t>* pixels, int* h,
                 int* w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  // corrupt headers can claim absurd dimensions; cap the decode buffer
  // (crops are ≤ a few hundred px — 100 MPix is far beyond any real input)
  if (*w <= 0 || *h <= 0 ||
      static_cast<size_t>(*w) * static_cast<size_t>(*h) > 100000000ull) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  pixels->resize(static_cast<size_t>(*w) * *h * 3);
  const int stride = *w * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = pixels->data() +
                   static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

}  // namespace

extern "C" {

// Decode `n` JPEG files into out (n, size, size, 3) RGB u8 using `threads`
// worker threads. ok[i] = 1 on success, 0 on failure (row left zeroed).
// Returns the number of successfully decoded images.
int fac_decode_batch(const char** paths, int n, int size, uint8_t* out,
                     uint8_t* ok, int threads) {
  std::atomic<int> next(0);
  std::atomic<int> good(0);
  const size_t row_bytes = static_cast<size_t>(size) * size * 3;

  auto worker = [&]() {
    std::vector<uint8_t> pixels;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      int h = 0, w = 0;
      uint8_t* dst = out + row_bytes * i;
      bool decoded = false;
      // an exception escaping a std::thread is std::terminate (SIGABRT for
      // the whole process) — a corrupt file must only fail its own row
      try {
        decoded = decode_jpeg(paths[i], &pixels, &h, &w) && h > 0 && w > 0;
      } catch (...) {
        decoded = false;
      }
      if (decoded) {
        if (h == size && w == size) {
          std::memcpy(dst, pixels.data(), row_bytes);
        } else {
          resize_bilinear(pixels.data(), h, w, dst, size, size);
        }
        ok[i] = 1;
        good.fetch_add(1);
      } else {
        std::memset(dst, 0, row_bytes);
        ok[i] = 0;
      }
    }
  };

  if (threads <= 1 || n <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    const int t = threads < n ? threads : n;
    pool.reserve(t);
    for (int i = 0; i < t; ++i) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return good.load();
}

}  // extern "C"
