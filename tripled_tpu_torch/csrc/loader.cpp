// Host image loader of tripled_tpu_torch: a copy of the JAX package's
// `tripled_tpu/data/native/loader.cpp`, so that the port needs nothing of
// that package.
//
// PNG and JPEG decode (libpng, libjpeg), PIL's two-pass fixed-point
// Lanczos-3 resize (antialiased on downscale by widening the filter's
// support), an optional horizontal flip after the resize, float32 [0,1]
// HWC output, and a batch call that spreads the images over std::threads.
// The samples must equal the JAX package's bit for bit, so the arithmetic
// is that file's, line for line.
//
// Plain C ABI, bound with ctypes (`tripled_tpu_torch/data/native_loader.py`)
// and built with g++ by `tripled_tpu_torch/utils/cuda_build.py`.

#include <png.h>
#include <jpeglib.h>
#include <setjmp.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image8 {
  int h = 0, w = 0;
  std::vector<uint8_t> rgb;  // HWC, 3 channels
};

// ----------------------------------------------------------------- PNG

struct PngReadState {
  const uint8_t* data;
  size_t size;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  auto* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + n > s->size) {
    png_error(png, "png: read past end");
  }
  memcpy(out, s->data + s->pos, n);
  s->pos += n;
}

bool decode_png(const uint8_t* data, size_t size, Image8* out) {
  if (size < 8 || png_sig_cmp(data, 0, 8)) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState state{data, size, 0};
  png_set_read_fn(png, &state, png_read_fn);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  // normalize to 8-bit RGB
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  // drop alpha
  if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->h = static_cast<int>(h);
  out->w = static_cast<int>(w);
  out->rgb.resize(size_t(h) * w * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 r = 0; r < h; ++r) rows[r] = out->rgb.data() + size_t(r) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// ----------------------------------------------------------------- JPEG

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

bool decode_jpeg(const uint8_t* data, size_t size, Image8* out) {
  if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), size);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->rgb.resize(size_t(out->h) * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ------------------------------------------------------------ Lanczos-3
//
// Byte-exact reproduction of PIL's two-pass fixed-point resampler
// (Pillow Resample.c semantics: horizontal pass to a uint8 intermediate,
// then vertical pass, 22-bit fixed-point coefficients with round-half-away
// conversion and clip8 output). The reference loads frames with
// `pil_loader` + `Image.resize(..., LANCZOS)` (`mono/datasets/
// mono_dataset.py:18-23,74`); matching PIL bit-for-bit keeps the training
// distribution identical to the reference pipeline.

constexpr int kPrecisionBits = 32 - 8 - 2;  // PIL PRECISION_BITS = 22

inline uint8_t clip8(int32_t in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

inline double sinc_filter(double x) {
  if (x == 0.0) return 1.0;
  x = x * M_PI;
  return std::sin(x) / x;
}

inline double lanczos3(double x) {
  if (-3.0 <= x && x < 3.0) return sinc_filter(x) * sinc_filter(x / 3.0);
  return 0.0;
}

struct FilterBank {
  int ksize;                    // taps per output element
  std::vector<int> xmin;        // first source index per output element
  std::vector<int> xmax;        // tap count per output element
  std::vector<int32_t> coeffs;  // ksize fixed-point weights per element
};

// PIL precompute_coeffs + normalize_coeffs_8bpc, including the exact
// window rounding `(int)(center ± support + 0.5)` and the /sum(w)
// normalization in double before fixed-point conversion.
FilterBank build_filter(int in_size, int out_size) {
  FilterBank fb;
  double scale = double(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = 3.0 * filterscale;
  fb.ksize = int(std::ceil(support)) * 2 + 1;
  fb.xmin.resize(out_size);
  fb.xmax.resize(out_size);
  fb.coeffs.assign(size_t(out_size) * fb.ksize, 0);
  std::vector<double> k(fb.ksize);
  double ss = 1.0 / filterscale;
  for (int i = 0; i < out_size; ++i) {
    double center = (i + 0.5) * scale;
    int lo = int(center - support + 0.5);
    if (lo < 0) lo = 0;
    int hi = int(center + support + 0.5);
    if (hi > in_size) hi = in_size;
    hi -= lo;
    double sum = 0.0;
    for (int x = 0; x < hi; ++x) {
      double w = lanczos3((x + lo - center + 0.5) * ss);
      k[x] = w;
      sum += w;
    }
    int32_t* kk = &fb.coeffs[size_t(i) * fb.ksize];
    for (int x = 0; x < hi; ++x) {
      double w = (sum != 0.0) ? k[x] / sum : k[x];
      kk[x] = int32_t(w < 0 ? -0.5 + w * (1 << kPrecisionBits)
                            : 0.5 + w * (1 << kPrecisionBits));
    }
    fb.xmin[i] = lo;
    fb.xmax[i] = hi;
  }
  return fb;
}

// resize RGB8 (h,w) -> float32 (oh,ow), [0,1], optional hflip.
// Two quantized passes exactly like PIL: horizontal first, uint8 between.
void resize_lanczos(const Image8& img, int oh, int ow, bool flip, float* out) {
  FilterBank fx = build_filter(img.w, ow);
  FilterBank fy = build_filter(img.h, oh);

  // horizontal pass: (h, ow, 3) uint8
  std::vector<uint8_t> tmp(size_t(img.h) * ow * 3);
  for (int y = 0; y < img.h; ++y) {
    const uint8_t* row = img.rgb.data() + size_t(y) * img.w * 3;
    uint8_t* trow = tmp.data() + size_t(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      const int32_t* kk = &fx.coeffs[size_t(x) * fx.ksize];
      const uint8_t* src = row + size_t(fx.xmin[x]) * 3;
      int32_t ss0 = 1 << (kPrecisionBits - 1);
      int32_t ss1 = ss0, ss2 = ss0;
      for (int t = 0; t < fx.xmax[x]; ++t) {
        ss0 += src[t * 3 + 0] * kk[t];
        ss1 += src[t * 3 + 1] * kk[t];
        ss2 += src[t * 3 + 2] * kk[t];
      }
      trow[x * 3 + 0] = clip8(ss0);
      trow[x * 3 + 1] = clip8(ss1);
      trow[x * 3 + 2] = clip8(ss2);
    }
  }
  // vertical pass + float conversion + optional flip. A multiply by 1/255,
  // as the JAX package's loader does: a divide by 255 rounds some values
  // the other way.
  const float inv255 = 1.0f / 255.0f;
  for (int y = 0; y < oh; ++y) {
    const int32_t* kk = &fy.coeffs[size_t(y) * fy.ksize];
    const uint8_t* src0 = tmp.data() + size_t(fy.xmin[y]) * ow * 3;
    float* orow = out + size_t(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      int32_t ss0 = 1 << (kPrecisionBits - 1);
      int32_t ss1 = ss0, ss2 = ss0;
      for (int t = 0; t < fy.xmax[y]; ++t) {
        const uint8_t* px = src0 + (size_t(t) * ow + x) * 3;
        ss0 += px[0] * kk[t];
        ss1 += px[1] * kk[t];
        ss2 += px[2] * kk[t];
      }
      int ox = flip ? (ow - 1 - x) : x;
      float* dst = orow + size_t(ox) * 3;
      dst[0] = clip8(ss0) * inv255;
      dst[1] = clip8(ss1) * inv255;
      dst[2] = clip8(ss2) * inv255;
    }
  }
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize(n);
  size_t got = fread(out->data(), 1, n, f);
  fclose(f);
  return got == size_t(n);
}

int load_one(const char* path, int oh, int ow, int flip, float* out) {
  std::vector<uint8_t> bytes;
  if (!read_file(path, &bytes)) return -1;
  Image8 img;
  if (!decode_png(bytes.data(), bytes.size(), &img) &&
      !decode_jpeg(bytes.data(), bytes.size(), &img))
    return -2;
  resize_lanczos(img, oh, ow, flip != 0, out);
  return 0;
}

}  // namespace

extern "C" {

// Decode + Lanczos resize one image file into float32 HWC [0,1].
// Returns 0 on success, -1 file error, -2 decode error.
int tripled_load_image(const char* path, int out_h, int out_w, int flip,
                       float* out) {
  return load_one(path, out_h, out_w, flip, out);
}

// Batched threaded variant: n images into out[n, out_h, out_w, 3].
// paths: array of n C strings; flips: n ints. Returns number of failures.
int tripled_load_batch(const char** paths, int n, int out_h, int out_w,
                       const int* flips, float* out, int num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::vector<int> status(n, 0);
  size_t stride = size_t(out_h) * out_w * 3;
  auto worker = [&](int tid) {
    for (int i = tid; i < n; i += num_threads) {
      status[i] = load_one(paths[i], out_h, out_w, flips[i], out + stride * i);
    }
  };
  if (num_threads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < num_threads; ++t) ts.emplace_back(worker, t);
    for (auto& t : ts) t.join();
  }
  int fails = 0;
  for (int s : status) fails += (s != 0);
  return fails;
}

// Decode only (native resolution), for callers that need raw pixels.
// Returns 0 and writes (h, w) on success; buffer must hold max_bytes.
int tripled_decode(const uint8_t* data, long size, uint8_t* out,
                   long max_bytes, int* h, int* w) {
  Image8 img;
  if (!decode_png(data, size_t(size), &img) &&
      !decode_jpeg(data, size_t(size), &img))
    return -2;
  long need = long(img.h) * img.w * 3;
  if (need > max_bytes) return -3;
  memcpy(out, img.rgb.data(), need);
  *h = img.h;
  *w = img.w;
  return 0;
}
}
