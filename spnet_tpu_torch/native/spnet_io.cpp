// spnet_io: native data-loading pipeline (the PyTorch port's copy of
// spnet_tpu/native/spnet_io.cpp).
//
// Replaces the reference's Python multiprocessing +
// shared-ctypes image reader (spnet/utils.py:323-421):
// a C++ thread pool decodes PNG frames (zlib inflate + per-row
// unfiltering), resizes them to the model input resolution (Lanczos3 —
// the reference's PIL ANTIALIAS — or box), and
// writes Inception-scaled float32 pixels straight into the caller's
// pinned output buffer — one pass, no Python object churn, no process
// forks.  Exposed to Python via a plain C ABI consumed with ctypes
// (spnet_tpu_torch/native/io.py).
//
// Supported PNG subset (everything the SPNet data contract produces):
// 8-bit greyscale / grey+alpha / RGB / RGBA, non-interlaced.  Color
// sources keep channel 0, matching the reference's grayscale path
// (utils.py:346).

#include <zlib.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int w = 0, h = 0, channels = 0;
  std::vector<uint8_t> pix;  // row-major, interleaved
};

uint32_t read_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Returns false on any parse error.
bool decode_png(const std::string& path, Image* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(sz);
  if (fread(buf.data(), 1, sz, f) != size_t(sz)) {
    fclose(f);
    return false;
  }
  fclose(f);

  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (sz < 8 || memcmp(buf.data(), kSig, 8) != 0) return false;

  int w = 0, h = 0, bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  while (pos + 8 <= size_t(sz)) {
    uint32_t len = read_be32(&buf[pos]);
    const char* type = reinterpret_cast<const char*>(&buf[pos + 4]);
    const uint8_t* data = &buf[pos + 8];
    if (pos + 12 + len > size_t(sz)) return false;
    if (memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) return false;  // truncated IHDR: fields below read 13 bytes
      w = read_be32(data);
      h = read_be32(data + 4);
      bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (w <= 0 || h <= 0 || bit_depth != 8 || interlace != 0) return false;
  int ch;
  switch (color_type) {
    case 0: ch = 1; break;  // grey
    case 2: ch = 3; break;  // RGB
    case 4: ch = 2; break;  // grey + alpha
    case 6: ch = 4; break;  // RGBA
    default: return false;   // (palette unsupported)
  }

  const size_t stride = size_t(w) * ch;
  std::vector<uint8_t> raw((stride + 1) * h);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size()) {
    return false;
  }

  out->w = w;
  out->h = h;
  out->channels = ch;
  out->pix.resize(stride * h);
  const int bpp = ch;  // bytes per pixel (8-bit)
  for (int y = 0; y < h; ++y) {
    const uint8_t filter = raw[(stride + 1) * y];
    const uint8_t* src = &raw[(stride + 1) * y + 1];
    uint8_t* dst = &out->pix[stride * y];
    const uint8_t* up = y > 0 ? &out->pix[stride * (y - 1)] : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= size_t(bpp)) ? up[x - bpp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return false;
      }
      dst[x] = uint8_t(v);
    }
  }
  return true;
}

// Separable box resample of channel 0 into float32 [-1, 1].
void resize_norm(const Image& img, int size, float* out) {
  const int w = img.w, h = img.h, ch = img.channels;
  const double sx = double(w) / size, sy = double(h) / size;
  std::vector<float> rowbuf(size_t(h) * size);  // horizontal pass

  for (int y = 0; y < h; ++y) {
    const uint8_t* src = &img.pix[size_t(y) * w * ch];
    for (int x = 0; x < size; ++x) {
      double x0 = x * sx, x1 = (x + 1) * sx;
      int ix0 = int(x0), ix1 = int(x1);
      if (ix1 >= w) ix1 = w - 1;
      double acc = 0.0, wsum = 0.0;
      for (int i = ix0; i <= ix1; ++i) {
        double cov = std::min<double>(x1, i + 1) - std::max<double>(x0, i);
        if (cov <= 0) cov = (ix0 == ix1) ? 1.0 : 0.0;
        acc += src[size_t(i) * ch] * cov;
        wsum += cov;
      }
      rowbuf[size_t(y) * size + x] = float(acc / (wsum > 0 ? wsum : 1));
    }
  }
  for (int x = 0; x < size; ++x) {
    for (int y = 0; y < size; ++y) {
      double y0 = y * sy, y1 = (y + 1) * sy;
      int iy0 = int(y0), iy1 = int(y1);
      if (iy1 >= h) iy1 = h - 1;
      double acc = 0.0, wsum = 0.0;
      for (int i = iy0; i <= iy1; ++i) {
        double cov = std::min<double>(y1, i + 1) - std::max<double>(y0, i);
        if (cov <= 0) cov = (iy0 == iy1) ? 1.0 : 0.0;
        acc += rowbuf[size_t(i) * size + x] * cov;
        wsum += cov;
      }
      float v = float(acc / (wsum > 0 ? wsum : 1));
      // Inception scaling (reference utils.py:340-342)
      out[size_t(y) * size + x] = (v / 255.0f - 0.5f) * 2.0f;
    }
  }
}

// ---------------------------------------------------------------------
// Lanczos3 separable resample, PIL-compatible.
//
// The reference loads real datasets with PIL's ANTIALIAS (= LANCZOS)
// filter (spnet/utils.py:337); this reproduces
// Pillow's algorithm: per-axis support = 3 * scale, kernel
// sinc(t) * sinc(t/3) sampled at (i + 0.5 - center) / scale with
// normalized weights, horizontal pass first, each pass rounded and
// clipped to uint8 like Pillow's 8-bit path.

double lanczos3(double t) {
  if (t <= -3.0 || t >= 3.0) return 0.0;
  if (t == 0.0) return 1.0;
  const double pit = 3.14159265358979323846 * t;
  return 3.0 * std::sin(pit) * std::sin(pit / 3.0) / (pit * pit);
}

// One-axis PIL-style resample: in (n_lines x in_size, stride between
// consecutive samples of a line = in_stride, between lines = line_stride)
// -> out laid out the same way with out sizes.
void resample_axis_u8(const uint8_t* in, int in_size, size_t in_stride,
                      size_t in_line_stride, int n_lines, int out_size,
                      uint8_t* out, size_t out_stride,
                      size_t out_line_stride) {
  const double scale = double(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 3.0 * filterscale;
  const double ss = 1.0 / filterscale;

  std::vector<int> bounds(2 * out_size);
  std::vector<double> kk;
  std::vector<int> koff(out_size + 1, 0);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    double wsum = 0.0;
    const size_t base = kk.size();
    for (int x = xmin; x < xmax; ++x) {
      double w = lanczos3((x - center + 0.5) * ss);
      kk.push_back(w);
      wsum += w;
    }
    if (wsum != 0.0) {
      for (size_t i = base; i < kk.size(); ++i) kk[i] /= wsum;
    }
    bounds[2 * xx] = xmin;
    bounds[2 * xx + 1] = xmax - xmin;
    koff[xx + 1] = int(kk.size());
  }

  for (int line = 0; line < n_lines; ++line) {
    const uint8_t* src = in + size_t(line) * in_line_stride;
    uint8_t* dst = out + size_t(line) * out_line_stride;
    for (int xx = 0; xx < out_size; ++xx) {
      const int xmin = bounds[2 * xx], cnt = bounds[2 * xx + 1];
      const double* k = &kk[koff[xx]];
      double acc = 0.0;
      for (int i = 0; i < cnt; ++i) {
        acc += src[size_t(xmin + i) * in_stride] * k[i];
      }
      int v = int(acc + 0.5);  // Pillow clip8: round then clamp
      if (v < 0) v = 0;
      if (v > 255) v = 255;
      dst[size_t(xx) * out_stride] = uint8_t(v);
    }
  }
}

// Lanczos3 resample of channel 0 into float32 [-1, 1] (PIL ANTIALIAS
// twin; horizontal then vertical pass, uint8 rounding per pass like
// Pillow's 8-bit path).
void resize_norm_lanczos(const Image& img, int size, float* out) {
  const int w = img.w, h = img.h, ch = img.channels;
  // channel-0 view is handled via strides; horizontal pass
  std::vector<uint8_t> mid(size_t(h) * size);
  resample_axis_u8(img.pix.data(), w, ch, size_t(w) * ch, h, size,
                   mid.data(), 1, size);
  // vertical pass: lines are now COLUMNS of mid
  std::vector<uint8_t> fin(size_t(size) * size);
  resample_axis_u8(mid.data(), h, size, 1, size, size,
                   fin.data(), size, 1);
  for (size_t p = 0; p < fin.size(); ++p) {
    out[p] = (fin[p] / 255.0f - 0.5f) * 2.0f;
  }
}

}  // namespace

extern "C" {

// Decode + resize + normalize n images into out (n * size * size floats).
// size <= 0 keeps native resolution (all images must share it; the first
// image defines it).  filter: 0 = box (area average), 1 = Lanczos3 (the
// reference's PIL ANTIALIAS).  Returns the number of successfully loaded
// images; failed slots are zero-filled and, when `status` is non-null,
// marked 0 in status[i] (1 = decoded) so the caller can retry them
// elsewhere.
int spnet_load_images_ex(const char** paths, int n, int size, float* out,
                         int n_threads, uint8_t* status, int filter) {
  if (n <= 0) return 0;
  if (status) memset(status, 0, n);
  std::atomic<int> next(0), ok(0);
  if (n_threads <= 0) n_threads = int(std::thread::hardware_concurrency());
  if (n_threads <= 0) n_threads = 1;
  if (n_threads > n) n_threads = n;

  // resolve native resolution from the first image when size <= 0
  int out_size = size;
  int native_w = 0, native_h = 0;
  if (size <= 0) {
    Image img;
    if (!decode_png(paths[0], &img)) return 0;
    native_w = img.w;
    native_h = img.h;
  }

  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      Image img;
      bool good = decode_png(paths[i], &img);
      if (size > 0) {
        float* dst = out + size_t(i) * out_size * out_size;
        if (good) {
          if (filter == 1) {
            resize_norm_lanczos(img, out_size, dst);
          } else {
            resize_norm(img, out_size, dst);
          }
          ok.fetch_add(1);
          if (status) status[i] = 1;
        } else {
          memset(dst, 0, sizeof(float) * out_size * out_size);
        }
      } else {
        float* dst = out + size_t(i) * native_w * native_h;
        if (good && img.w == native_w && img.h == native_h) {
          for (int p = 0; p < native_w * native_h; ++p) {
            dst[p] = (img.pix[size_t(p) * img.channels] / 255.0f - 0.5f)
                     * 2.0f;
          }
          ok.fetch_add(1);
          if (status) status[i] = 1;
        } else {
          memset(dst, 0, sizeof(float) * native_w * native_h);
        }
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok.load();
}

// Back-compat ABIs (box filter).
int spnet_load_images_status(const char** paths, int n, int size,
                             float* out, int n_threads, uint8_t* status) {
  return spnet_load_images_ex(paths, n, size, out, n_threads, status, 0);
}

int spnet_load_images(const char** paths, int n, int size, float* out,
                      int n_threads) {
  return spnet_load_images_ex(paths, n, size, out, n_threads, nullptr, 0);
}

// Probe the dimensions of one PNG.  Returns 0 on success.
int spnet_png_dims(const char* path, int* w, int* h) {
  Image img;
  if (!decode_png(path, &img)) return 1;
  *w = img.w;
  *h = img.h;
  return 0;
}

}  // extern "C"
