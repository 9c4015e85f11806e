// Host-side JPEG decode pool of the input pipeline: the port's own copy of
// plip_tpu/native/decode.cpp.
//
// Replacement for the decode half of the reference's DataLoader
// worker processes (SURVEY.md §2.2 N5): the reference forks torch workers
// that decode via PIL; here a C++ thread pool decodes straight into a
// preallocated batch buffer with zero Python-object overhead and no GIL
// involvement. Two entry points:
//
//   ptn_decode_file        — decode one JPEG to RGB (variable size); the
//                            PIL-convention resize then runs on-device
//                            (ops/resize.py), keeping the fidelity path exact.
//   ptn_decode_batch_fixed — decode + shortest-side resize + center crop a
//                            whole batch into out[n, crop, crop, 3] with an
//                            internal thread pool (bilinear; the fast path
//                            for bulk throughput). Uses libjpeg DCT scaling
//                            (M/8) to cut IDCT cost on large tiles before the
//                            bilinear stage.
//
// Build: g++ -O3 -shared -fPIC decode.cpp -o libptn_decode.so -ljpeg -lpthread

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

extern "C" {

struct ptn_error_mgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

static void ptn_error_exit(j_common_ptr cinfo) {
  ptn_error_mgr* err = reinterpret_cast<ptn_error_mgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode `path`; allocates nothing the caller doesn't own. Returns 0 on
// success. out must hold cap bytes; fails if decoded RGB exceeds cap.
// If scale_shorter > 0, applies libjpeg DCT scaling picking the smallest M/8
// whose shorter output side is still >= scale_shorter (never upscales).
int ptn_decode_file(const char* path, uint8_t* out, long cap, int* out_w,
                    int* out_h, int scale_shorter) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;

  jpeg_decompress_struct cinfo;
  ptn_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = ptn_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -2;  // corrupt / not a jpeg
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  if (scale_shorter > 0) {
    int shorter = cinfo.image_width < cinfo.image_height ? cinfo.image_width
                                                         : cinfo.image_height;
    int num = 8;
    for (int m = 1; m <= 8; ++m) {
      if ((long)shorter * m / 8 >= scale_shorter) {
        num = m;
        break;
      }
    }
    cinfo.scale_num = num;
    cinfo.scale_denom = 8;
  }

  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  const int ch = cinfo.output_components;  // 3 for RGB
  if ((long)w * h * 3 > cap || ch != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -3;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + (long)cinfo.output_scanline * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  *out_w = w;
  *out_h = h;
  return 0;
}

// Decode into a growable vector sized exactly from the JPEG header (avoids
// the cost of zero-initializing a large fixed scratch per call).
static int decode_into_vector(const char* path, std::vector<uint8_t>& buf,
                              int* out_w, int* out_h, int scale_shorter,
                              int* orig_w = nullptr, int* orig_h = nullptr) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  jpeg_decompress_struct cinfo;
  ptn_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = ptn_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  if (orig_w) *orig_w = cinfo.image_width;
  if (orig_h) *orig_h = cinfo.image_height;
  cinfo.out_color_space = JCS_RGB;
  if (scale_shorter > 0) {
    int shorter = cinfo.image_width < cinfo.image_height ? cinfo.image_width
                                                         : cinfo.image_height;
    int num = 8;
    for (int m = 1; m <= 8; ++m) {
      if ((long)shorter * m / 8 >= scale_shorter) {
        num = m;
        break;
      }
    }
    cinfo.scale_num = num;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  if (cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -3;
  }
  if ((long)buf.size() < (long)w * h * 3) buf.resize((long)w * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf.data() + (long)cinfo.output_scanline * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  *out_w = w;
  *out_h = h;
  return 0;
}

// Bilinear shortest-side resize to `shorter` + center crop `crop` x `crop`.
static void resize_center_crop(const uint8_t* src, int sw, int sh,
                               uint8_t* dst, int shorter, int crop) {
  double scale = (double)shorter / (sw < sh ? sw : sh);
  int rw = (int)std::lround(sw * scale);
  int rh = (int)std::lround(sh * scale);
  if (rw < crop) rw = crop;
  if (rh < crop) rh = crop;
  const int left = (rw - crop) / 2, top = (rh - crop) / 2;
  const double inv_x = (double)sw / rw, inv_y = (double)sh / rh;

  for (int y = 0; y < crop; ++y) {
    double fy = (y + top + 0.5) * inv_y - 0.5;
    if (fy < 0) fy = 0;
    int y0 = (int)fy;
    if (y0 > sh - 2) y0 = sh - 2 < 0 ? 0 : sh - 2;
    double wy = fy - y0;
    int y1 = y0 + 1 < sh ? y0 + 1 : y0;
    for (int x = 0; x < crop; ++x) {
      double fx = (x + left + 0.5) * inv_x - 0.5;
      if (fx < 0) fx = 0;
      int x0 = (int)fx;
      if (x0 > sw - 2) x0 = sw - 2 < 0 ? 0 : sw - 2;
      double wx = fx - x0;
      int x1 = x0 + 1 < sw ? x0 + 1 : x0;
      const uint8_t* p00 = src + ((long)y0 * sw + x0) * 3;
      const uint8_t* p01 = src + ((long)y0 * sw + x1) * 3;
      const uint8_t* p10 = src + ((long)y1 * sw + x0) * 3;
      const uint8_t* p11 = src + ((long)y1 * sw + x1) * 3;
      uint8_t* o = dst + ((long)y * crop + x) * 3;
      for (int c = 0; c < 3; ++c) {
        double v = (1 - wy) * ((1 - wx) * p00[c] + wx * p01[c]) +
                   wy * ((1 - wx) * p10[c] + wx * p11[c]);
        o[c] = (uint8_t)(v + 0.5);
      }
    }
  }
}

// Decode n JPEGs into out[n, crop, crop, 3] using `threads` workers.
// status[i] = 0 on bit-exact success (source was already crop x crop, no
// resampling happened), 1 on success WITH resampling (DCT scaling and/or the
// host bilinear resize ran — approximate vs the PIL-bicubic contract,
// reproducibility/embedders/transform.py:45-52), negative error code
// otherwise (failed slots are zero-filled; the caller decides whether to
// skip or retry via PIL).
int ptn_decode_batch_fixed(const char** paths, int n, int shorter, int crop,
                           uint8_t* out, int* status, int threads) {
  if (threads <= 0) threads = std::thread::hardware_concurrency();
  std::atomic<int> next(0);
  const long slot = (long)crop * crop * 3;

  auto worker = [&]() {
    // scratch sized from each JPEG header; grows monotonically per worker
    std::vector<uint8_t> scratch;
    int i;
    while ((i = next.fetch_add(1)) < n) {
      int w = 0, h = 0, ow = 0, oh = 0;
      int rc = decode_into_vector(paths[i], scratch, &w, &h, shorter, &ow, &oh);
      status[i] = rc;
      uint8_t* dst = out + (long)i * slot;
      if (rc == 0) {
        if (w == crop && h == crop) {
          memcpy(dst, scratch.data(), slot);
          // DCT scaling can land exactly on crop x crop (e.g. 256 -> 7/8 ->
          // 224): the tile is target-sized but was still RESAMPLED. Only a
          // source that was crop x crop in the header is bit-exact.
          if (ow != crop || oh != crop) status[i] = 1;
        } else {
          resize_center_crop(scratch.data(), w, h, dst, shorter, crop);
          status[i] = 1;  // resampled: approximate vs the bicubic contract
        }
      } else {
        memset(dst, 0, slot);
      }
    }
  };

  std::vector<std::thread> pool;
  int nt = threads < n ? threads : n;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return 0;
}

int ptn_version() { return 2; }

}  // extern "C"
