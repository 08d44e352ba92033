// Native data-loader core: fused JPEG decode -> crop -> resize -> normalize.
//
// TPU-native replacement for the reference's inherited native input path
// (torch DataLoader C++ workers + PIL/libjpeg decode; SURVEY.md §2
// "native-code surface is entirely inherited through PyTorch"). The train
// pipeline needs ~thousands of decoded images per second per host; this core
// does, per sample, in one pass without intermediate Python objects:
//
//   1. libjpeg decode with DCT scaling (1/2, 1/4, 1/8) chosen so the decoded
//      image is the smallest one still >= the requested crop resolution —
//      decoding a 2000px photo for a 224px crop touches ~1/64 of the pixels.
//   2. crop (box given by the caller in ORIGINAL image coordinates; the
//      Python side draws RandomResizedCrop parameters so augmentation
//      semantics and RNG stay in one place)
//   3. bilinear resample to the target size
//   4. normalize to float32 (x/255 - mean) / std, channels-last
//
// cx_process_batch fans samples out over a std::thread pool. Exported via a
// plain C ABI for ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -shared -fPIC dataloader.cc -o _native.so -ljpeg -pthread

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decoded image buffer (RGB8, row-major).
struct Image {
  std::vector<uint8_t> data;
  int w = 0, h = 0;
};

// Decode with DCT scaling: pick scale 8/N so result >= min_w x min_h.
bool decode_jpeg(const uint8_t* buf, size_t len, int min_w, int min_h,
                 Image* out) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  // choose the most aggressive DCT downscale that keeps both dims >= min
  if (min_w > 0 && min_h > 0) {
    int denom = 1;
    for (int d = 2; d <= 8; d *= 2) {
      if (static_cast<int>(cinfo.image_width) / d >= min_w &&
          static_cast<int>(cinfo.image_height) / d >= min_h) {
        denom = d;
      } else {
        break;
      }
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  if (cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  out->data.resize(static_cast<size_t>(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() +
                   static_cast<size_t>(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Precomputed separable filter taps for one output axis (PIL-style
// triangle/linear filter with support scaled by the downscale factor).
struct Taps {
  std::vector<int> start;       // first source index per output pixel
  std::vector<int> count;       // tap count per output pixel
  std::vector<float> weights;   // flattened [out][max_count]
  int max_count = 0;
};

Taps make_taps(float origin, float span, int out_size, int src_size) {
  Taps t;
  const float scale = span / out_size;
  const float support = std::max(1.0f, scale);  // widen filter on downscale
  t.max_count = static_cast<int>(std::ceil(support * 2)) + 2;
  t.start.resize(out_size);
  t.count.resize(out_size);
  t.weights.assign(static_cast<size_t>(out_size) * t.max_count, 0.0f);
  for (int i = 0; i < out_size; ++i) {
    float center = origin + (i + 0.5f) * scale;
    int lo = std::max(0, static_cast<int>(std::floor(center - support + 0.5f)));
    int hi = std::min(src_size,
                      static_cast<int>(std::floor(center + support + 0.5f)));
    if (hi <= lo) {
      lo = std::min(std::max(0, static_cast<int>(center)), src_size - 1);
      hi = lo + 1;
    }
    float total = 0.0f;
    int cnt = hi - lo;
    cnt = std::min(cnt, t.max_count);
    for (int k = 0; k < cnt; ++k) {
      float dist = (lo + k + 0.5f - center) / support;
      float w = 1.0f - std::fabs(dist);
      w = std::max(w, 0.0f);
      t.weights[static_cast<size_t>(i) * t.max_count + k] = w;
      total += w;
    }
    if (total > 0) {
      for (int k = 0; k < cnt; ++k)
        t.weights[static_cast<size_t>(i) * t.max_count + k] /= total;
    }
    t.start[i] = lo;
    t.count[i] = cnt;
  }
  return t;
}

// PIL-convention separable resample from a crop region of src into
// out_h x out_w, then either normalize into float32 channels-last (out_f)
// or emit uint8 RGB (out_u8; "normalize on device" mode — the train step
// does (x/255 - mean)/std on the accelerator, cutting host->device traffic
// 4x; mean/stdv may be null in that mode).
void resample_normalize(const Image& src, float cx0, float cy0, float cw,
                        float ch, int out_h, int out_w, const float* mean,
                        const float* stdv, float* out_f, uint8_t* out_u8) {
  const Taps tx = make_taps(cx0, cw, out_w, src.w);
  const Taps ty = make_taps(cy0, ch, out_h, src.h);
  // pass 1: horizontal, all source rows -> [src_h, out_w, 3]
  std::vector<float> mid(static_cast<size_t>(src.h) * out_w * 3);
  for (int y = 0; y < src.h; ++y) {
    const uint8_t* srow = src.data.data() + static_cast<size_t>(y) * src.w * 3;
    float* mrow = mid.data() + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      float acc[3] = {0, 0, 0};
      const int lo = tx.start[x];
      const int cnt = tx.count[x];
      const float* w = tx.weights.data() + static_cast<size_t>(x) * tx.max_count;
      for (int k = 0; k < cnt; ++k) {
        const uint8_t* px = srow + (lo + k) * 3;
        acc[0] += w[k] * px[0];
        acc[1] += w[k] * px[1];
        acc[2] += w[k] * px[2];
      }
      mrow[x * 3 + 0] = acc[0];
      mrow[x * 3 + 1] = acc[1];
      mrow[x * 3 + 2] = acc[2];
    }
  }
  // pass 2: vertical + normalize (float path) or round-clamp (uint8 path)
  const float inv255 = 1.0f / 255.0f;
  float inv_std[3] = {1.0f, 1.0f, 1.0f};
  if (stdv != nullptr) {
    inv_std[0] = 1.0f / stdv[0];
    inv_std[1] = 1.0f / stdv[1];
    inv_std[2] = 1.0f / stdv[2];
  }
  for (int y = 0; y < out_h; ++y) {
    const int lo = ty.start[y];
    const int cnt = ty.count[y];
    const float* w = ty.weights.data() + static_cast<size_t>(y) * ty.max_count;
    for (int x = 0; x < out_w; ++x) {
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < cnt; ++k) {
        const float* px =
            mid.data() + (static_cast<size_t>(lo + k) * out_w + x) * 3;
        acc[0] += w[k] * px[0];
        acc[1] += w[k] * px[1];
        acc[2] += w[k] * px[2];
      }
      if (out_f != nullptr) {
        float* orow = out_f + static_cast<size_t>(y) * out_w * 3;
        for (int c = 0; c < 3; ++c) {
          orow[x * 3 + c] = (acc[c] * inv255 - mean[c]) * inv_std[c];
        }
      } else {
        uint8_t* orow = out_u8 + static_cast<size_t>(y) * out_w * 3;
        for (int c = 0; c < 3; ++c) {
          // PIL rounds half away from zero on uint8 convert
          float v = acc[c] + 0.5f;
          orow[x * 3 + c] = static_cast<uint8_t>(
              std::min(255.0f, std::max(0.0f, v)));
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Peek dimensions without full decode. Returns 0 on success.
int cx_jpeg_info(const uint8_t* data, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode + crop(+resize) + normalize one sample.
// crop = (x, y, w, h) in ORIGINAL image coords; pass w<=0 for eval-style
// resize-shortest-then-center-crop. Exactly one of out/out_u8 is non-null
// (float32 normalized vs raw uint8 RGB). Returns 0 on success.
int cx_process_sample_impl(const uint8_t* jpeg, size_t len, float* out,
                           uint8_t* out_u8, int out_h, int out_w, int crop_x,
                           int crop_y, int crop_w, int crop_h,
                           const float* mean, const float* stdv) {
  Image img;
  int min_w = out_w, min_h = out_h;
  int w0 = 0, h0 = 0;  // original dims, parsed ONCE for the crop path
  if (crop_w > 0) {
    // need decoded res such that the crop region maps to >= out size:
    // decode scale s => crop_w*s >= out_w  => decoded_w >= orig_w*out_w/crop_w
    if (cx_jpeg_info(jpeg, len, &w0, &h0) != 0) return 1;
    min_w = static_cast<int>(
        std::ceil(static_cast<double>(w0) * out_w / crop_w));
    min_h = static_cast<int>(
        std::ceil(static_cast<double>(h0) * out_h / crop_h));
  }
  if (!decode_jpeg(jpeg, len, min_w, min_h, &img)) return 1;

  float cx0, cy0, cw, ch;
  if (crop_w > 0) {
    // crop box given in original coords; rescale to decoded coords
    // (w0/h0 from the single header parse above)
    double sx = static_cast<double>(img.w) / w0;
    double sy = static_cast<double>(img.h) / h0;
    cx0 = static_cast<float>(crop_x * sx);
    cy0 = static_cast<float>(crop_y * sy);
    cw = static_cast<float>(crop_w * sx);
    ch = static_cast<float>(crop_h * sy);
  } else {
    // eval: resize shortest side to out, center crop
    float scale = std::max(static_cast<float>(out_w) / img.w,
                           static_cast<float>(out_h) / img.h);
    cw = out_w / scale;
    ch = out_h / scale;
    cx0 = (img.w - cw) * 0.5f;
    cy0 = (img.h - ch) * 0.5f;
  }
  resample_normalize(img, cx0, cy0, cw, ch, out_h, out_w, mean, stdv, out,
                     out_u8);
  return 0;
}

int cx_process_sample(const uint8_t* jpeg, size_t len, float* out, int out_h,
                      int out_w, int crop_x, int crop_y, int crop_w,
                      int crop_h, const float* mean, const float* stdv) {
  return cx_process_sample_impl(jpeg, len, out, nullptr, out_h, out_w, crop_x,
                                crop_y, crop_w, crop_h, mean, stdv);
}

// Batch version over a thread pool. crops: n*4 ints or nullptr (eval mode
// for all). Exactly one of out/out_u8 is non-null. Returns the number of
// FAILED samples; failed slots are zeroed.
static int process_batch_impl(const uint8_t** jpegs, const size_t* lens,
                              int n, float* out, uint8_t* out_u8, int out_h,
                              int out_w, const int* crops, const float* mean,
                              const float* stdv, int num_threads) {
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  const size_t stride = static_cast<size_t>(out_h) * out_w * 3;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int cx = -1, cy = -1, cw = -1, ch = -1;
      if (crops != nullptr) {
        cx = crops[i * 4 + 0];
        cy = crops[i * 4 + 1];
        cw = crops[i * 4 + 2];
        ch = crops[i * 4 + 3];
      }
      float* of = out != nullptr ? out + stride * i : nullptr;
      uint8_t* ou = out_u8 != nullptr ? out_u8 + stride * i : nullptr;
      if (cx_process_sample_impl(jpegs[i], lens[i], of, ou, out_h, out_w,
                                 cx, cy, cw, ch, mean, stdv) != 0) {
        if (of != nullptr) std::memset(of, 0, stride * sizeof(float));
        if (ou != nullptr) std::memset(ou, 0, stride);
        failures.fetch_add(1);
      }
    }
  };
  int t = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(t);
  for (int i = 0; i < t; ++i) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failures.load();
}

int cx_process_batch(const uint8_t** jpegs, const size_t* lens, int n,
                     float* out, int out_h, int out_w, const int* crops,
                     const float* mean, const float* stdv, int num_threads) {
  return process_batch_impl(jpegs, lens, n, out, nullptr, out_h, out_w, crops,
                            mean, stdv, num_threads);
}

// uint8 output mode: decode+crop+resize only; normalization happens on the
// accelerator (the caller ships 1/4 the bytes host->device).
int cx_process_batch_u8(const uint8_t** jpegs, const size_t* lens, int n,
                        uint8_t* out, int out_h, int out_w, const int* crops,
                        int num_threads) {
  return process_batch_impl(jpegs, lens, n, nullptr, out, out_h, out_w, crops,
                            nullptr, nullptr, num_threads);
}

// Batch RGB -> planar YUV 4:2:0 wire-format conversion (ops/yuv420.py):
// in  [n, h, w, 3] uint8, out [n, h*3/2, w] uint8 (Y rows, then Cb | Cr
// side by side at h/2 x w/2). BT.601 full-range with the SAME 16-bit
// fixed-point coefficients as the numpy fallback, chroma from the rounded
// 2x2 box mean — the two paths are bit-identical (pinned by test). h, w
// must be even. Memory-bound: threads split on images.
int cx_rgb_to_yuv420(const uint8_t* in, int n, int h, int w, uint8_t* out,
                     int num_threads) {
  if ((h | w) & 1) return 1;
  const size_t in_stride = static_cast<size_t>(h) * w * 3;
  const size_t out_stride = static_cast<size_t>(h) * w * 3 / 2;
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      const uint8_t* src = in + in_stride * i;
      uint8_t* y_out = out + out_stride * i;
      uint8_t* cb_out = y_out + static_cast<size_t>(h) * w;
      // Y plane
      for (int r = 0; r < h; ++r) {
        const uint8_t* p = src + static_cast<size_t>(r) * w * 3;
        uint8_t* q = y_out + static_cast<size_t>(r) * w;
        for (int c = 0; c < w; ++c, p += 3) {
          q[c] = static_cast<uint8_t>(
              (19595 * p[0] + 38470 * p[1] + 7471 * p[2] + 32768) >> 16);
        }
      }
      // chroma from the rounded 2x2 box mean; rows h..h*3/2-1 hold
      // Cb (cols 0..w/2-1) and Cr (cols w/2..w-1)
      const int hw = w / 2;
      for (int r = 0; r < h / 2; ++r) {
        const uint8_t* p0 = src + static_cast<size_t>(2 * r) * w * 3;
        const uint8_t* p1 = p0 + static_cast<size_t>(w) * 3;
        uint8_t* qb = cb_out + static_cast<size_t>(r) * w;
        uint8_t* qr = qb + hw;
        for (int c = 0; c < hw; ++c) {
          const int o = c * 6;
          int rs = (p0[o] + p0[o + 3] + p1[o] + p1[o + 3] + 2) >> 2;
          int gs = (p0[o + 1] + p0[o + 4] + p1[o + 1] + p1[o + 4] + 2) >> 2;
          int bs = (p0[o + 2] + p0[o + 5] + p1[o + 2] + p1[o + 5] + 2) >> 2;
          int cb = ((-11059 * rs - 21709 * gs + 32768 * bs + 32768) >> 16) + 128;
          int cr = ((32768 * rs - 27439 * gs - 5329 * bs + 32768) >> 16) + 128;
          qb[c] = static_cast<uint8_t>(cb < 0 ? 0 : (cb > 255 ? 255 : cb));
          qr[c] = static_cast<uint8_t>(cr < 0 ? 0 : (cr > 255 ? 255 : cr));
        }
      }
    }
  };
  int t = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(t);
  for (int i = 0; i < t; ++i) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
