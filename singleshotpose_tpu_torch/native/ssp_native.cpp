// Native data-loader core of the PyTorch port: fused JPEG/PNG decode +
// background composite + crop/resize + HSV distortion, with a std::thread
// batch API, and the pixel core of the multi-object scene synthesizer.
//
// The port's own copy of singleshotpose_tpu/native/ssp_native.cpp: the code
// is the same, so both packages decode and augment to the same bytes
// (tests/test_torch_native.py holds the two libraries equal).  It implements
// the augmentation semantics of data/augment.py in C++ (libjpeg/libpng
// decode, center-sample nearest resize, zero-padded crop, alpha composite,
// PIL-scaled HSV shift) and parallelizes a whole batch with native threads:
// no GIL, no per-worker process.
//
// Randomness stays in Python: crop/shift/HSV parameters are drawn by the
// caller (numpy RandomState) and passed in, keeping the native path
// deterministic and bit-comparable with the pure-Python path.
//
// Built by native/__init__.py with g++ (-ljpeg -lpng -lpthread).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <list>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

namespace {

struct ImageU8 {
  std::vector<uint8_t> data;  // HWC, RGB
  int h = 0, w = 0;
};

// ---------------------------------------------------------------- decode --

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// min_w/min_h > 0 enable DCT decode-at-scale: the largest denominator in
// {1,2,4,8} keeping the decoded image >= (min_w, min_h) is applied, so a
// large source headed for a small target never materializes at full
// resolution (libjpeg scale_num/scale_denom — cheaper than decode+resize).
// ycbcr=true decodes to full-range BT.601 YCbCr (JPEG's native colorspace —
// skips libjpeg's color conversion) instead of RGB.
bool decode_jpeg(FILE* f, ImageU8* out, int min_w, int min_h,
                 bool ycbcr = false) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = ycbcr ? JCS_YCbCr : JCS_RGB;
  if (min_w > 0 && min_h > 0) {
    int denom = 1;
    while (denom < 8 &&
           int(cinfo.image_width) >= 2 * denom * min_w &&
           int(cinfo.image_height) >= 2 * denom * min_h)
      denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->data.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png(FILE* f, ImageU8* out) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
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
  png_init_io(png, f);
  png_read_info(png, info);
  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  // normalize everything to 8-bit RGB
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->w = int(w);
  out->h = int(h);
  out->data.resize(size_t(w) * h * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; y++)
    rows[y] = out->data.data() + size_t(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, ImageU8* out, int min_w = 0,
                 int min_h = 0) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t n = fread(magic, 1, 8, f);
  rewind(f);
  bool ok = false;
  if (n >= 3 && magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, out, min_w, min_h);
  } else if (n >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    ok = decode_png(f, out);  // PNG has no cheap decode-at-scale
  }
  fclose(f);
  return ok;
}

// Decode straight to full-range BT.601 YCbCr (interleaved HWC).  JPEGs skip
// the RGB conversion entirely; PNGs are converted with the JFIF constants.
bool decode_file_ycbcr(const char* path, ImageU8* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t n = fread(magic, 1, 8, f);
  rewind(f);
  bool ok = false;
  bool need_convert = false;
  if (n >= 3 && magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, out, 0, 0, /*ycbcr=*/true);
  } else if (n >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    ok = decode_png(f, out);
    need_convert = ok;
  }
  fclose(f);
  if (need_convert) {
    size_t npx = size_t(out->w) * out->h;
    for (size_t i = 0; i < npx; i++) {
      float r = out->data[i * 3], g = out->data[i * 3 + 1],
            b = out->data[i * 3 + 2];
      float y = 0.299f * r + 0.587f * g + 0.114f * b;
      float cb = 128.0f - 0.168736f * r - 0.331264f * g + 0.5f * b;
      float cr = 128.0f + 0.5f * r - 0.418688f * g - 0.081312f * b;
      out->data[i * 3] = uint8_t(std::min(std::max(y + .5f, 0.f), 255.f));
      out->data[i * 3 + 1] = uint8_t(std::min(std::max(cb + .5f, 0.f), 255.f));
      out->data[i * 3 + 2] = uint8_t(std::min(std::max(cr + .5f, 0.f), 255.f));
    }
  }
  return ok;
}

// ------------------------------------------------- background image cache --
//
// The train path decodes one randomly-picked VOC background per sample
// (reference: image.py:129-142 picks + PIL-decodes every time).  Backgrounds
// repeat across samples/epochs, so a byte-capped LRU keyed by path removes
// that decode entirely on a hit.  Entries are decoded at scale toward the
// compositing size (the bg is resized to the foreground dims anyway).

struct BgCache {
  std::mutex mu;
  size_t cap = 1ull << 30;  // 1 GiB default; ssp_bg_cache_limit overrides
  size_t used = 0;
  std::list<std::string> lru;  // front = most recent
  struct Entry {
    std::shared_ptr<const ImageU8> img;
    std::list<std::string>::iterator it;
  };
  std::unordered_map<std::string, Entry> map;

  std::shared_ptr<const ImageU8> get(const std::string& key) {
    std::lock_guard<std::mutex> lock(mu);
    auto it = map.find(key);
    if (it == map.end()) return nullptr;
    lru.splice(lru.begin(), lru, it->second.it);
    return it->second.img;
  }

  void put(const std::string& key, std::shared_ptr<const ImageU8> img) {
    size_t sz = img->data.size();
    std::lock_guard<std::mutex> lock(mu);
    if (cap == 0 || sz > cap || map.count(key)) return;
    while (used + sz > cap && !lru.empty()) {
      auto& victim = lru.back();
      auto vit = map.find(victim);
      used -= vit->second.img->data.size();
      map.erase(vit);
      lru.pop_back();
    }
    lru.push_front(key);
    map.emplace(key, Entry{std::move(img), lru.begin()});
    used += sz;
  }

  void clear() {
    std::lock_guard<std::mutex> lock(mu);
    map.clear();
    lru.clear();
    used = 0;
  }

  void set_cap(size_t bytes) {
    std::lock_guard<std::mutex> lock(mu);
    map.clear();
    lru.clear();
    used = 0;
    cap = bytes;
  }
};

BgCache g_bg_cache;

std::shared_ptr<const ImageU8> decode_bg_cached(const char* path, int min_w,
                                                int min_h) {
  // the decoded pixels depend on the scale target, so it is part of the key
  std::string key = std::string(path) + "@" + std::to_string(min_w) + "x" +
                    std::to_string(min_h);
  if (auto hit = g_bg_cache.get(key)) return hit;
  auto img = std::make_shared<ImageU8>();
  if (!decode_file(path, img.get(), min_w, min_h)) return nullptr;
  std::shared_ptr<const ImageU8> cimg = std::move(img);
  g_bg_cache.put(key, cimg);
  return cimg;
}

// ------------------------------------------------------------- transforms --

// Center-sample nearest resize (augment.resize_nearest).  Identity is one
// memcpy; repeated source rows (upscaling) are row-copies of the previous
// output row instead of re-gathering.
void resize_nearest(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                    int dw) {
  if (sh == dh && sw == dw) {
    memcpy(dst, src, size_t(sh) * sw * 3);
    return;
  }
  std::vector<int> xi3(dw), yi(dh);
  for (int x = 0; x < dw; x++)
    xi3[x] = std::min(int((x + 0.5) * sw / dw), sw - 1) * 3;
  for (int y = 0; y < dh; y++)
    yi[y] = std::min(int((y + 0.5) * sh / dh), sh - 1);
  int prev = -1;
  for (int y = 0; y < dh; y++) {
    uint8_t* drow = dst + size_t(y) * dw * 3;
    if (yi[y] == prev) {
      memcpy(drow, drow - size_t(dw) * 3, size_t(dw) * 3);
      continue;
    }
    prev = yi[y];
    const uint8_t* srow = src + size_t(yi[y]) * sw * 3;
    uint8_t* d = drow;
    for (int x = 0; x < dw; x++) {
      const uint8_t* s = srow + xi3[x];
      d[0] = s[0];
      d[1] = s[1];
      d[2] = s[2];
      d += 3;
    }
  }
}

// img = img*alpha + bg*(1-alpha), alpha = mask/255 (augment.change_background);
// bg is resized to img dims on the fly.
void composite_bg(ImageU8* img, const ImageU8& mask, const ImageU8& bg) {
  ImageU8 bgr;
  bgr.h = img->h;
  bgr.w = img->w;
  bgr.data.resize(size_t(img->h) * img->w * 3);
  resize_nearest(bg.data.data(), bg.h, bg.w, bgr.data.data(), img->h, img->w);
  size_t npx = size_t(img->h) * img->w * 3;  // caller checked mask dims
  for (size_t i = 0; i < npx; i++) {
    float a = mask.data[i] / 255.0f;
    img->data[i] = uint8_t(img->data[i] * a + bgr.data[i] * (1.0f - a));
  }
}

// Zero-padded crop (pleft,ptop,cw,ch) + nearest resize (augment.crop_resize).
void crop_resize(const ImageU8& src, int pleft, int ptop, int cw, int ch,
                 uint8_t* dst, int dw, int dh) {
  ImageU8 crop;
  crop.h = ch;
  crop.w = cw;
  crop.data.assign(size_t(ch) * cw * 3, 0);
  int y0 = std::max(ptop, 0), y1 = std::min(ptop + ch, src.h);
  int x0 = std::max(pleft, 0), x1 = std::min(pleft + cw, src.w);
  for (int y = y0; y < y1; y++) {
    memcpy(crop.data.data() + (size_t(y - ptop) * cw + (x0 - pleft)) * 3,
           src.data.data() + (size_t(y) * src.w + x0) * 3,
           size_t(x1 - x0) * 3);
  }
  resize_nearest(crop.data.data(), ch, cw, dst, dh, dw);
}

// HSV distortion matching augment.distort_hsv (PIL 0..255 hue scale,
// single wraparound, sat/val clip).
void distort_hsv(uint8_t* img, int h, int w, float dhue, float dsat,
                 float dexp) {
  size_t n = size_t(h) * w;
  for (size_t i = 0; i < n; i++) {
    float r = img[i * 3 + 0] / 255.0f;
    float g = img[i * 3 + 1] / 255.0f;
    float b = img[i * 3 + 2] / 255.0f;
    float mx = std::max({r, g, b}), mn = std::min({r, g, b});
    float d = mx - mn;
    float hue;
    if (d == 0) {
      hue = 0;
    } else if (mx == r) {
      hue = (g - b) / d;
      hue -= 6.0f * std::floor(hue / 6.0f);  // fmod into [0,6)
    } else if (mx == g) {
      hue = (b - r) / d + 2.0f;
    } else {
      hue = (r - g) / d + 4.0f;
    }
    hue /= 6.0f;
    float s = mx == 0 ? 0 : d / mx;
    float v = mx;
    // quantize to u8 like the numpy path (astype(uint8) truncation)
    uint8_t hq = uint8_t(hue * 255.0f);
    uint8_t sq = uint8_t(s * 255.0f);
    uint8_t vq = uint8_t(v * 255.0f);
    float sf = std::min(std::max(sq * dsat, 0.0f), 255.0f);
    float vf = std::min(std::max(vq * dexp, 0.0f), 255.0f);
    float hf = hq + dhue * 255.0f;
    if (hf > 255.0f) hf -= 255.0f;
    if (hf < 0.0f) hf += 255.0f;
    // back to RGB (matches augment.hsv_to_rgb_u8)
    float hh = uint8_t(hf) * 6.0f / 255.0f;
    float ss = uint8_t(sf) / 255.0f;
    float vv = uint8_t(vf) / 255.0f;
    int ii = int(std::floor(hh)) % 6;
    float ff = hh - std::floor(hh);
    float p = vv * (1 - ss), q = vv * (1 - ss * ff),
          t = vv * (1 - ss * (1 - ff));
    float rr, gg, bb;
    switch (ii) {
      case 0: rr = vv; gg = t; bb = p; break;
      case 1: rr = q; gg = vv; bb = p; break;
      case 2: rr = p; gg = vv; bb = t; break;
      case 3: rr = p; gg = q; bb = vv; break;
      case 4: rr = t; gg = p; bb = vv; break;
      default: rr = vv; gg = p; bb = q; break;
    }
    img[i * 3 + 0] = uint8_t(std::min(std::max(rr * 255.0f, 0.0f), 255.0f));
    img[i * 3 + 1] = uint8_t(std::min(std::max(gg * 255.0f, 0.0f), 255.0f));
    img[i * 3 + 2] = uint8_t(std::min(std::max(bb * 255.0f, 0.0f), 255.0f));
  }
}

}  // namespace

extern "C" {

// Background-cache controls: byte cap (0 disables caching) and flush.
void ssp_bg_cache_limit(long bytes) {
  g_bg_cache.set_cap(bytes < 0 ? 0 : size_t(bytes));
}

void ssp_bg_cache_clear(void) { g_bg_cache.clear(); }

// Decode to caller buffer (cap bytes). Returns 0 ok, sets *w/*h; -1 I/O or
// decode error, -2 buffer too small (then *w/*h carry the needed dims).
int ssp_decode_rgb(const char* path, uint8_t* out, long cap, int* w, int* h) {
  ImageU8 img;
  if (!decode_file(path, &img)) return -1;
  *w = img.w;
  *h = img.h;
  long need = long(img.w) * img.h * 3;
  if (need > cap) return -2;
  memcpy(out, img.data.data(), size_t(need));
  return 0;
}

// Fused single-object train sample core (PoseDataset.get_train semantics):
// decode img+mask+bg, composite, zero-padded crop (pleft,ptop,cw,ch),
// nearest resize to (out_w,out_h), HSV distort → uint8 HWC.
// bgpath may be NULL (skip composite). Returns 0 ok.
static int train_sample_u8(const char* imgpath, const char* maskpath,
                           const char* bgpath, int pleft, int ptop, int cw,
                           int ch, int out_w, int out_h, float dhue,
                           float dsat, float dexp, uint8_t* out) {
  ImageU8 img;
  if (!decode_file(imgpath, &img)) return -1;
  if (bgpath && maskpath) {
    ImageU8 mask;
    if (!decode_file(maskpath, &mask)) return -2;
    // backgrounds go through the LRU cache, decoded at scale toward the
    // compositing dims (they get nearest-resized to the foreground anyway,
    // so DCT-scaled decode of a large source is visually equivalent and
    // skips most of the work; LINEMOD-sized sources decode at denom 1,
    // bit-identical to the Python path)
    auto bg = decode_bg_cached(bgpath, img.w, img.h);
    if (!bg) return -3;
    if (mask.w != img.w || mask.h != img.h) return -4;
    composite_bg(&img, mask, *bg);
  }
  crop_resize(img, pleft, ptop, cw, ch, out, out_w, out_h);
  distort_hsv(out, out_h, out_w, dhue, dsat, dexp);
  return 0;
}

// f32 [0,1] variant (legacy layout; the u8 batch path transfers 4x less).
int ssp_train_sample(const char* imgpath, const char* maskpath,
                     const char* bgpath, int pleft, int ptop, int cw, int ch,
                     int out_w, int out_h, float dhue, float dsat, float dexp,
                     float* out) {
  std::vector<uint8_t> sized(size_t(out_w) * out_h * 3);
  int rc = train_sample_u8(imgpath, maskpath, bgpath, pleft, ptop, cw, ch,
                           out_w, out_h, dhue, dsat, dexp, sized.data());
  if (rc != 0) return rc;
  size_t n = size_t(out_w) * out_h * 3;
  for (size_t i = 0; i < n; i++) out[i] = sized[i] / 255.0f;
  return 0;
}

// Decode + nearest-resize one image to float32 HWC/255 (test path).
int ssp_test_sample(const char* imgpath, int out_w, int out_h, float* out) {
  ImageU8 img;
  if (!decode_file(imgpath, &img)) return -1;
  std::vector<uint8_t> sized(size_t(out_w) * out_h * 3);
  resize_nearest(img.data.data(), img.h, img.w, sized.data(), out_h, out_w);
  size_t n = size_t(out_w) * out_h * 3;
  for (size_t i = 0; i < n; i++) out[i] = sized[i] / 255.0f;
  return 0;
}

// u8 variant: decode + resize only — normalization happens on-device, so
// host→device transfers carry 4x less data than the float path.
int ssp_test_sample_u8(const char* imgpath, int out_w, int out_h,
                       uint8_t* out) {
  ImageU8 img;
  if (!decode_file(imgpath, &img)) return -1;
  resize_nearest(img.data.data(), img.h, img.w, out, out_h, out_w);
  return 0;
}

// Batched fused train samples across native threads.
// crops: int[4*n] (pleft,ptop,cw,ch per sample); hsv: float[3*n];
// out: float[n*out_h*out_w*3]; status: int[n]. nthreads<=0 → hw concurrency.
void ssp_train_batch(int n, const char** imgpaths, const char** maskpaths,
                     const char** bgpaths, const int* crops, const float* hsv,
                     int out_w, int out_h, float* out, int* status,
                     int nthreads) {
  if (nthreads <= 0) nthreads = int(std::thread::hardware_concurrency());
  nthreads = std::max(1, std::min(nthreads, n));
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      status[i] = ssp_train_sample(
          imgpaths[i], maskpaths ? maskpaths[i] : nullptr,
          bgpaths ? bgpaths[i] : nullptr, crops[4 * i], crops[4 * i + 1],
          crops[4 * i + 2], crops[4 * i + 3], out_w, out_h, hsv[3 * i],
          hsv[3 * i + 1], hsv[3 * i + 2],
          out + size_t(i) * out_w * out_h * 3);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// uint8 train batch: same augmentation, 1/4 the host→device bytes (the
// device normalizes — u8/255 there equals the f32/255 here bit-exactly).
void ssp_train_batch_u8(int n, const char** imgpaths, const char** maskpaths,
                        const char** bgpaths, const int* crops,
                        const float* hsv, int out_w, int out_h, uint8_t* out,
                        int* status, int nthreads) {
  if (nthreads <= 0) nthreads = int(std::thread::hardware_concurrency());
  nthreads = std::max(1, std::min(nthreads, n));
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      status[i] = train_sample_u8(
          imgpaths[i], maskpaths ? maskpaths[i] : nullptr,
          bgpaths ? bgpaths[i] : nullptr, crops[4 * i], crops[4 * i + 1],
          crops[4 * i + 2], crops[4 * i + 3], out_w, out_h, hsv[3 * i],
          hsv[3 * i + 1], hsv[3 * i + 2],
          out + size_t(i) * out_w * out_h * 3);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

void ssp_test_batch_u8(int n, const char** imgpaths, int out_w, int out_h,
                       uint8_t* out, int* status, int nthreads) {
  if (nthreads <= 0) nthreads = int(std::thread::hardware_concurrency());
  nthreads = std::max(1, std::min(nthreads, n));
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      status[i] = ssp_test_sample_u8(imgpaths[i], out_w, out_h,
                                     out + size_t(i) * out_w * out_h * 3);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// ---- multi-object scene synthesis (data/synth_multi.py pixel core) --------
//
// These mirror the numpy pixel ops BIT-EXACTLY (same f32 formulas, same
// truncation) while fusing the selection chain: zero-padded crop + nearest
// resize + wrap-around roll + optional horizontal flip are all pure index
// selections, so they compose into one gather, and the foreground
// multiplication commutes with selection (u8 product of selected values).
// All RNG draws stay in Python — the native path is draw-identical.

// Masked crop-resize: msized = u8(img_sel * mask_sel / 255f),
// masksized = mask_sel, where sel = flip ∘ roll(shift) ∘ resize ∘ crop.
// When total != NULL, also counts the synth rejection-test overlap
// (image_multi.py:340-353 semantics): area = #{max_c(masksized) > thresh},
// inter = #{that & max_c(total) > thresh}.  img/mask are (h,w,3) u8.
void ssp_synth_masked_resize(const uint8_t* img, const uint8_t* mask, int h,
                             int w, int pleft, int ptop, int cw, int ch,
                             int shift_x, int shift_y, int flip, int out_w,
                             int out_h, uint8_t* msized, uint8_t* masksized,
                             const uint8_t* total, int thresh, long* area,
                             long* inter) {
  auto mod = [](int v, int m) { int r = v % m; return r < 0 ? r + m : r; };
  // hoist the x mapping: flip ∘ roll ∘ resize ∘ crop is y-independent, so
  // precompute per-output-column source offsets (-1 = out of bounds / zero)
  std::vector<long> sx3(out_w);
  for (int x = 0; x < out_w; x++) {
    int fx = flip ? out_w - 1 - x : x;       // flip applied after roll
    int rx = mod(fx - shift_x, out_w);       // np.roll: out[x] = sized[x-s]
    int xi = std::min(int((rx + 0.5) * cw / out_w), cw - 1);
    int sx = pleft + xi;
    sx3[x] = (sx >= 0 && sx < w) ? long(sx) * 3 : -1;
  }
  long a = 0, in = 0;
  // mask-precomputed 1/255 reciprocal would change f32 results; keep /255.0f
  for (int y = 0; y < out_h; y++) {
    int ry = mod(y - shift_y, out_h);
    int yi = std::min(int((ry + 0.5) * ch / out_h), ch - 1);
    int sy = ptop + yi;
    bool yin = sy >= 0 && sy < h;
    uint8_t* mrow = msized + size_t(y) * out_w * 3;
    uint8_t* krow = masksized + size_t(y) * out_w * 3;
    const uint8_t* trow = total ? total + size_t(y) * out_w * 3 : nullptr;
    if (!yin) {
      memset(mrow, 0, size_t(out_w) * 3);
      memset(krow, 0, size_t(out_w) * 3);
      continue;                              // zero rows: no overlap counts
    }
    const uint8_t* irow = img + size_t(sy) * w * 3;
    const uint8_t* karow = mask + size_t(sy) * w * 3;
    for (int x = 0; x < out_w; x++) {
      long s3 = sx3[x];
      uint8_t mv0 = 0, mv1 = 0, mv2 = 0, kv0 = 0, kv1 = 0, kv2 = 0;
      if (s3 >= 0) {
        const uint8_t* ip = irow + s3;
        const uint8_t* kp = karow + s3;
        kv0 = kp[0]; kv1 = kp[1]; kv2 = kp[2];
        // mask_foreground: u8(f32(img) * (f32(mask)/255)) — truncation
        mv0 = uint8_t(float(ip[0]) * (kv0 / 255.0f));
        mv1 = uint8_t(float(ip[1]) * (kv1 / 255.0f));
        mv2 = uint8_t(float(ip[2]) * (kv2 / 255.0f));
      }
      mrow[x * 3 + 0] = mv0; mrow[x * 3 + 1] = mv1; mrow[x * 3 + 2] = mv2;
      krow[x * 3 + 0] = kv0; krow[x * 3 + 1] = kv1; krow[x * 3 + 2] = kv2;
      if (total) {
        int kmax = std::max({int(kv0), int(kv1), int(kv2)});
        if (kmax > thresh) {
          a++;
          int tmax = std::max({int(trow[x * 3]), int(trow[x * 3 + 1]),
                               int(trow[x * 3 + 2])});
          if (tmax > thresh) in++;
        }
      }
    }
  }
  if (area) *area = a;
  if (inter) *inter = in;
}

// Accepted-placement composite, one pass over npx3 = out_h*out_w*3 bytes:
//   canvas = u8(fg·α + canvas·(1−α)),          α = mask/255   (superimpose)
//   total  = u8(clip(mask + total·(1−mask/255), 0, 255))  (superimpose_masks)
// total may be NULL (final base re-paste updates the canvas only).
void ssp_synth_composite(const uint8_t* fg, const uint8_t* mask,
                         uint8_t* canvas, uint8_t* total, long npx3) {
  for (long i = 0; i < npx3; i++) {
    float m = mask[i];
    float a = m / 255.0f;
    canvas[i] = uint8_t(float(fg[i]) * a + float(canvas[i]) * (1.0f - a));
    if (total) {
      float t = m + float(total[i]) * (1.0f - m / 255.0f);
      total[i] = uint8_t(std::min(std::max(t, 0.0f), 255.0f));
    }
  }
}

// change_background on caller buffers: canvas = u8(canvas·α + bg_r·(1−α)),
// bg nearest-resized to (out_h,out_w) first.  mask is (out_h,out_w,3).
void ssp_change_background_buf(uint8_t* canvas, const uint8_t* mask,
                               int out_h, int out_w, const uint8_t* bg,
                               int bh, int bw) {
  std::vector<uint8_t> bgr(size_t(out_h) * out_w * 3);
  resize_nearest(bg, bh, bw, bgr.data(), out_h, out_w);
  size_t n = size_t(out_h) * out_w * 3;
  for (size_t i = 0; i < n; i++) {
    float a = mask[i] / 255.0f;
    canvas[i] = uint8_t(float(canvas[i]) * a + float(bgr[i]) * (1.0f - a));
  }
}

// Header-only image dimensions (no pixel decode). Returns 0 ok.
int ssp_image_dims(const char* path, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t magic[8] = {0};
  size_t n = fread(magic, 1, 8, f);
  rewind(f);
  int rc = -1;
  if (n >= 3 && magic[0] == 0xFF && magic[1] == 0xD8) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (!setjmp(jerr.jb)) {
      jpeg_create_decompress(&cinfo);
      jpeg_stdio_src(&cinfo, f);
      jpeg_read_header(&cinfo, TRUE);
      *w = cinfo.image_width;
      *h = cinfo.image_height;
      rc = 0;
    }
    jpeg_destroy_decompress(&cinfo);
  } else if (n >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    ImageU8 img;  // libpng has no one-call header read; decode (PNG = rare)
    rewind(f);
    if (decode_png(f, &img)) {
      *w = img.w;
      *h = img.h;
      rc = 0;
    }
  }
  fclose(f);
  return rc;
}

// Transfer-optimal eval batch: YUV 4:2:0 planes at NATIVE resolution —
// 1.5 B/px instead of RGB's 3 B/px at the (usually larger) eval size, so a
// bandwidth-limited host→device link carries ≥2x fewer bytes.  Chroma is
// 2x2 box-averaged from the decoded YCbCr (the JPEG stored it subsampled to
// begin with); the device reverses it (upsample + BT.601 matrix + nearest
// resize: ops/yuv.py).  All images must share (w, h); status -5 otherwise.
// y_out: n*h*w; cbcr_out: n*(h/2)*(w/2)*2 (interleaved Cb,Cr).
void ssp_test_batch_yuv420(int n, const char** imgpaths, int w, int h,
                           uint8_t* y_out, uint8_t* cbcr_out, int* status,
                           int nthreads) {
  if (nthreads <= 0) nthreads = int(std::thread::hardware_concurrency());
  nthreads = std::max(1, std::min(nthreads, n));
  int cw = w / 2, ch = h / 2;
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      ImageU8 img;
      if (!decode_file_ycbcr(imgpaths[i], &img)) {
        status[i] = -1;
        continue;
      }
      if (img.w != w || img.h != h) {
        status[i] = -5;
        continue;
      }
      uint8_t* yp = y_out + size_t(i) * w * h;
      const uint8_t* src = img.data.data();
      for (size_t p = 0, npx = size_t(w) * h; p < npx; p++)
        yp[p] = src[p * 3];
      uint8_t* cp = cbcr_out + size_t(i) * cw * ch * 2;
      for (int cy = 0; cy < ch; cy++) {
        const uint8_t* r0 = src + size_t(2 * cy) * w * 3;
        const uint8_t* r1 = src + size_t(2 * cy + 1) * w * 3;
        uint8_t* crow = cp + size_t(cy) * cw * 2;
        for (int cx = 0; cx < cw; cx++) {
          int x0 = 6 * cx, x1 = 6 * cx + 3;
          crow[cx * 2] = uint8_t(
              (r0[x0 + 1] + r0[x1 + 1] + r1[x0 + 1] + r1[x1 + 1] + 2) >> 2);
          crow[cx * 2 + 1] = uint8_t(
              (r0[x0 + 2] + r0[x1 + 2] + r1[x0 + 2] + r1[x1 + 2] + 2) >> 2);
        }
      }
      status[i] = 0;
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

void ssp_test_batch(int n, const char** imgpaths, int out_w, int out_h,
                    float* out, int* status, int nthreads) {
  if (nthreads <= 0) nthreads = int(std::thread::hardware_concurrency());
  nthreads = std::max(1, std::min(nthreads, n));
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      status[i] = ssp_test_sample(imgpaths[i], out_w, out_h,
                                  out + size_t(i) * out_w * out_h * 3);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

}  // extern "C"
