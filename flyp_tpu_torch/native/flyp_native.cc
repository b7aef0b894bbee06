// flyp_tpu_torch host data plane: image decode + CLIP transforms.
//
// The port's copy of the JAX package's native/flyp_native.cc.  ctypes
// releases the GIL for the whole decode or transform call, so the threaded
// loader (flyp_tpu_torch/data/loader.py) scales across host cores.
//
// Semantics mirror the Python transforms (flyp_tpu_torch/data/transforms.py),
// which themselves mirror CLIP's preprocessing:
//   * bicubic (a = -0.5) separable resampling with Pillow's coefficient
//     construction: antialias scaling of the filter when downsampling,
//     center-aligned sampling, source window clamped to the IMAGE bounds
//     (so a box-resize reads past the box edge, exactly like PIL
//     Image.resize(..., box=...)).
//   * train: crop box -> resize to (n_px, n_px) -> CLIP normalize
//   * eval: resize shortest side -> center crop -> CLIP normalize
//
// Codecs.  Each one is compiled in only when the build finds its header
// (flyp_tpu_torch/data/native_decode.py probes for it and sets the macro):
//   * FLYP_HAVE_JPEG: libjpeg (jpeglib.h, -ljpeg), as in the JAX package;
//   * FLYP_HAVE_PNG:  a PNG reader on zlib alone (zlib.h, -lz).  The JAX
//     package reads PNG with libpng; the NVIDIA H100 machine the port runs
//     on has zlib but neither libpng nor libjpeg.  The reader gives libpng's
//     pixels under the JAX package's transforms (see png_emit).
// A file of a codec that is compiled out returns kNoCodec from the decode
// entry points; flyp_codecs() says which codecs this build has.  The
// transform needs no external header and is always built.
//
// Build: g++ -O3 -shared -fPIC -ffp-contract=off [-DFLYP_HAVE_JPEG]
//        [-DFLYP_HAVE_PNG] flyp_native.cc [-ljpeg] [-lz] -o libflyp_native.so

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#ifdef FLYP_HAVE_JPEG
#include <jpeglib.h>
#endif
#ifdef FLYP_HAVE_PNG
#include <zlib.h>
#endif

namespace {

constexpr int kCorrupt = -1;  // unsupported format, or a corrupt file
constexpr int kNoCodec = -2;  // a JPEG or PNG whose codec this build lacks

// ---------------------------------------------------------------- JPEG ----

bool is_jpeg(const uint8_t* data, size_t len) {
  return len >= 3 && data[0] == 0xFF && data[1] == 0xD8 && data[2] == 0xFF;
}

#ifdef FLYP_HAVE_JPEG

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

int jpeg_info(const uint8_t* data, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  jpeg_read_header(&cinfo, TRUE);
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int jpeg_decode(const uint8_t* data, size_t len, uint8_t* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int stride = cinfo.output_width * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

#endif  // FLYP_HAVE_JPEG

// ----------------------------------------------------------------- PNG ----

bool is_png(const uint8_t* data, size_t len) {
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  return len >= 8 && std::memcmp(data, kSig, 8) == 0;
}

#ifdef FLYP_HAVE_PNG

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

struct PngHeader {
  uint32_t width = 0, height = 0;
  int depth = 0, color = 0, interlace = 0;
  int channels() const {
    switch (color) {
      case 2: return 3;
      case 4: return 2;
      case 6: return 4;
      default: return 1;  // gray (0), palette (3)
    }
  }
  size_t row_bytes(uint32_t w) const { return (size_t(w) * channels() * depth + 7) / 8; }
};

// One chunk at data[pos]: its type, body and length.  Critical chunks must
// pass their CRC (libpng's default); ancillary ones are not read.
bool png_chunk(const uint8_t* data, size_t len, size_t pos, const uint8_t** type, const uint8_t** body,
               uint32_t* n) {
  if (pos > len || len - pos < 12) return false;
  *n = be32(data + pos);
  if (*n > len - pos - 12) return false;
  *type = data + pos + 4;
  *body = *type + 4;
  const bool critical = ((*type)[0] & 0x20) == 0;
  return !critical || crc32(0, *type, *n + 4) == be32(*body + *n);
}

bool png_valid_header(const PngHeader& h) {
  if (h.width == 0 || h.height == 0 || h.width > 1000000 || h.height > 1000000) return false;  // libpng's limits
  switch (h.color) {
    case 0: return h.depth == 1 || h.depth == 2 || h.depth == 4 || h.depth == 8 || h.depth == 16;
    case 3: return h.depth == 1 || h.depth == 2 || h.depth == 4 || h.depth == 8;
    case 2: case 4: case 6: return h.depth == 8 || h.depth == 16;
    default: return false;
  }
}

// IHDR, which must be the first chunk.
int png_header(const uint8_t* data, size_t len, PngHeader* h) {
  const uint8_t *type, *body;
  uint32_t n;
  if (!png_chunk(data, len, 8, &type, &body, &n) || std::memcmp(type, "IHDR", 4) != 0 || n != 13) return kCorrupt;
  h->width = be32(body);
  h->height = be32(body + 4);
  h->depth = body[8];
  h->color = body[9];
  h->interlace = body[12];
  if (body[10] != 0 || body[11] != 0 || body[12] > 1 || !png_valid_header(*h)) return kCorrupt;
  return 0;
}

// Adam7's passes: first column, first row, column step, row step.
constexpr int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                              {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

uint32_t pass_extent(uint32_t size, int first, int step) {
  return size > uint32_t(first) ? (size - first + step - 1) / step : 0;
}

// Undo the row filters of one (sub)image of h rows of rb bytes, each row
// led by its filter byte, in place.
bool png_unfilter(uint8_t* rows, uint32_t h, size_t rb, size_t bpp) {
  const uint8_t* prev = nullptr;
  for (uint32_t y = 0; y < h; ++y) {
    uint8_t* cur = rows + y * (rb + 1) + 1;
    switch (cur[-1]) {
      case 0:
        break;
      case 1:
        for (size_t i = bpp; i < rb; ++i) cur[i] = uint8_t(cur[i] + cur[i - bpp]);
        break;
      case 2:
        if (prev)
          for (size_t i = 0; i < rb; ++i) cur[i] = uint8_t(cur[i] + prev[i]);
        break;
      case 3:
        for (size_t i = 0; i < rb; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
          cur[i] = uint8_t(cur[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < rb; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          cur[i] = uint8_t(cur[i] + ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c)));
        }
        break;
      default:
        return false;
    }
    prev = cur;
  }
  return true;
}

// Sample s of an unfiltered row, reduced to 8 bits as libpng's transforms
// of the JAX package's reader leave it: 16-bit samples keep their high byte
// (png_set_strip_16), gray of 1/2/4 bits scales by 255/85/17
// (png_set_expand_gray_1_2_4_to_8), palette indices stay indices.
inline int png_sample(const uint8_t* row, size_t s, const PngHeader& h) {
  if (h.depth == 8) return row[s];
  if (h.depth == 16) return row[2 * s];
  const size_t bit = s * h.depth;
  const int v = (row[bit >> 3] >> (8 - h.depth - int(bit & 7))) & ((1 << h.depth) - 1);
  return h.color == 3 ? v : v * (255 / ((1 << h.depth) - 1));
}

// Write n pixels of one row to out, pixel i at column x0 + i * dx, as RGB8:
// gray replicated (png_set_gray_to_rgb), palettes expanded through a
// 256-entry table whose entries past PLTE are black (libpng's zero-filled
// palette), alpha and tRNS dropped (png_set_tRNS_to_alpha, then
// png_set_strip_alpha).
void png_emit(const uint8_t* row, uint32_t n, const PngHeader& h, const uint8_t* palette, uint8_t* out,
              uint32_t x0, uint32_t dx) {
  const int c = h.channels();
  for (uint32_t i = 0; i < n; ++i) {
    uint8_t* px = out + size_t(x0 + i * dx) * 3;
    const size_t s = size_t(i) * c;
    if (h.color == 3) {
      std::memcpy(px, palette + 3 * png_sample(row, s, h), 3);
    } else if (h.color == 0 || h.color == 4) {
      px[0] = px[1] = px[2] = uint8_t(png_sample(row, s, h));
    } else {
      for (int k = 0; k < 3; ++k) px[k] = uint8_t(png_sample(row, s + k, h));
    }
  }
}

int png_decode(const uint8_t* data, size_t len, uint8_t* out) {
  PngHeader h;
  if (png_header(data, len, &h) != 0) return kCorrupt;
  uint8_t palette[256 * 3] = {0};
  bool have_palette = false;
  std::vector<uint8_t> idat;
  // The chunks after IHDR, up to IEND, which libpng also requires.
  for (size_t pos = 8 + 25;;) {
    const uint8_t *type, *body;
    uint32_t n;
    if (!png_chunk(data, len, pos, &type, &body, &n)) return kCorrupt;
    pos += 12 + size_t(n);
    if (std::memcmp(type, "IEND", 4) == 0) break;
    if (std::memcmp(type, "PLTE", 4) == 0) {
      if (n % 3 != 0 || n == 0 || n > sizeof(palette)) return kCorrupt;
      std::memcpy(palette, body, n);
      have_palette = true;
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      if (h.color == 3 && !have_palette) return kCorrupt;
      idat.insert(idat.end(), body, body + n);
    } else if ((type[0] & 0x20) == 0) {
      return kCorrupt;  // a second IHDR, or an unknown critical chunk
    }
  }
  // The (sub)images: the whole image, or Adam7's seven passes.
  const int passes = h.interlace ? 7 : 1;
  uint32_t pw[7], ph[7];
  size_t total = 0;
  for (int p = 0; p < passes; ++p) {
    pw[p] = h.interlace ? pass_extent(h.width, kAdam7[p][0], kAdam7[p][2]) : h.width;
    ph[p] = h.interlace ? pass_extent(h.height, kAdam7[p][1], kAdam7[p][3]) : h.height;
    if (pw[p] != 0 && ph[p] != 0) total += size_t(ph[p]) * (h.row_bytes(pw[p]) + 1);
  }
  if (idat.empty() || idat.size() > 0xFFFFFFFFu || total > 0xFFFFFFFFu) return kCorrupt;
  std::vector<uint8_t> raw(total);
  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) return kCorrupt;
  zs.next_in = idat.data();
  zs.avail_in = uInt(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = uInt(raw.size());
  const int zrc = inflate(&zs, Z_FINISH);
  const size_t produced = raw.size() - zs.avail_out;
  inflateEnd(&zs);
  // Z_BUF_ERROR with the output full: data past the image, which libpng
  // reports as a warning and ignores.
  if (produced != raw.size() || (zrc != Z_STREAM_END && zrc != Z_BUF_ERROR)) return kCorrupt;

  const size_t bpp = std::max<size_t>(1, size_t(h.channels()) * h.depth / 8);
  uint8_t* sub = raw.data();
  for (int p = 0; p < passes; ++p) {
    if (pw[p] == 0 || ph[p] == 0) continue;
    const size_t rb = h.row_bytes(pw[p]);
    if (!png_unfilter(sub, ph[p], rb, bpp)) return kCorrupt;
    const uint32_t x0 = h.interlace ? kAdam7[p][0] : 0, dx = h.interlace ? kAdam7[p][2] : 1;
    const uint32_t y0 = h.interlace ? kAdam7[p][1] : 0, dy = h.interlace ? kAdam7[p][3] : 1;
    for (uint32_t y = 0; y < ph[p]; ++y) {
      png_emit(sub + y * (rb + 1) + 1, pw[p], h, palette, out + size_t(y0 + y * dy) * h.width * 3, x0, dx);
    }
    sub += size_t(ph[p]) * (rb + 1);
  }
  return 0;
}

#endif  // FLYP_HAVE_PNG

// ------------------------------------------------------------- resample ----

// Pillow's bicubic kernel, a = -0.5, support 2.
inline double bicubic(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct Coeffs {
  std::vector<int> xmin;       // per output index: first source index
  std::vector<int> xsize;      // per output index: number of taps
  std::vector<double> weights; // ksize doubles per output index
  int ksize = 0;
};

// Pillow precompute_coeffs: box [in0, in1) mapped to out_size samples,
// source window clamped to [0, in_size).
Coeffs precompute(int in_size, double in0, double in1, int out_size) {
  Coeffs c;
  const double scale = (in1 - in0) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.xmin.resize(out_size);
  c.xsize.resize(out_size);
  c.weights.assign(static_cast<size_t>(out_size) * c.ksize, 0.0);
  const double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = in0 + (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &c.weights[static_cast<size_t>(xx) * c.ksize];
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      const double w = bicubic((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    if (ww != 0.0) {
      for (int x = 0; x < xmax; ++x) k[x] /= ww;
    }
    c.xmin[xx] = xmin;
    c.xsize[xx] = xmax;
  }
  return c;
}

}  // namespace

extern "C" {

// Bit 0: this build decodes JPEG; bit 1: PNG.
int flyp_codecs() {
  int codecs = 0;
#ifdef FLYP_HAVE_JPEG
  codecs |= 1;
#endif
#ifdef FLYP_HAVE_PNG
  codecs |= 2;
#endif
  return codecs;
}

// Image header sniff: fills (*w, *h); returns 0 ok, kCorrupt for an
// unsupported or corrupt file, kNoCodec for a codec this build lacks.
int flyp_image_info(const uint8_t* data, size_t len, int* w, int* h) {
  if (is_jpeg(data, len)) {
#ifdef FLYP_HAVE_JPEG
    return jpeg_info(data, len, w, h);
#else
    return kNoCodec;
#endif
  }
  if (is_png(data, len)) {
#ifdef FLYP_HAVE_PNG
    PngHeader hdr;
    if (png_header(data, len, &hdr) != 0) return kCorrupt;
    *w = static_cast<int>(hdr.width);
    *h = static_cast<int>(hdr.height);
    return 0;
#else
    return kNoCodec;
#endif
  }
  return kCorrupt;
}

// Decode to RGB8 HWC into caller-allocated out[h*w*3]; the same codes.
int flyp_decode_rgb(const uint8_t* data, size_t len, uint8_t* out) {
  if (is_jpeg(data, len)) {
#ifdef FLYP_HAVE_JPEG
    return jpeg_decode(data, len, out);
#else
    return kNoCodec;
#endif
  }
  if (is_png(data, len)) {
#ifdef FLYP_HAVE_PNG
    return png_decode(data, len, out);
#else
    return kNoCodec;
#endif
  }
  return kCorrupt;
}

// Bicubic box-resize + optional center crop + CLIP normalize.
//
//   rgb:        source RGB8 HWC [h, w, 3]
//   bx0..by1:   source box (floats; filter window clamps to image bounds)
//   rs_w, rs_h: resize target
//   cx, cy, cs: post-resize crop (left, top, size); cs <= 0 -> whole resize
//   mean, stdv: per-channel normalization constants
//   out:        float32 HWC [cs|rs_h, cs|rs_w, 3]
int flyp_transform(const uint8_t* rgb, int h, int w,
                   double bx0, double by0, double bx1, double by1,
                   int rs_w, int rs_h,
                   int cx, int cy, int cs,
                   const float* mean, const float* stdv,
                   float* out) {
  if (rs_w <= 0 || rs_h <= 0 || w <= 0 || h <= 0) return -1;
  const Coeffs cw_ = precompute(w, bx0, bx1, rs_w);
  const Coeffs ch_ = precompute(h, by0, by1, rs_h);

  // Rows of the source actually referenced by the vertical pass.
  int ymin_used = h, ymax_used = 0;
  for (int yy = 0; yy < rs_h; ++yy) {
    ymin_used = std::min(ymin_used, ch_.xmin[yy]);
    ymax_used = std::max(ymax_used, ch_.xmin[yy] + ch_.xsize[yy]);
  }
  if (ymin_used >= ymax_used) return -1;
  const int used_h = ymax_used - ymin_used;

  // Horizontal pass on the used rows: [used_h, rs_w, 3].  Pillow's 8bpc
  // resample clips + rounds the intermediate image back to uint8 between
  // the two passes; mirror that, or overshoot handling diverges visibly.
  auto clamp8 = [](double v) -> uint8_t {
    v = v < 0.0 ? 0.0 : (v > 255.0 ? 255.0 : v);
    return static_cast<uint8_t>(std::floor(v + 0.5));
  };
  std::vector<uint8_t> tmp(static_cast<size_t>(used_h) * rs_w * 3);
  for (int y = 0; y < used_h; ++y) {
    const uint8_t* src = rgb + static_cast<size_t>(y + ymin_used) * w * 3;
    uint8_t* dst = &tmp[static_cast<size_t>(y) * rs_w * 3];
    for (int xx = 0; xx < rs_w; ++xx) {
      const double* k = &cw_.weights[static_cast<size_t>(xx) * cw_.ksize];
      const int x0 = cw_.xmin[xx], n = cw_.xsize[xx];
      double r = 0, g = 0, b = 0;
      for (int x = 0; x < n; ++x) {
        const uint8_t* p = src + static_cast<size_t>(x0 + x) * 3;
        r += k[x] * p[0];
        g += k[x] * p[1];
        b += k[x] * p[2];
      }
      dst[xx * 3 + 0] = clamp8(r);
      dst[xx * 3 + 1] = clamp8(g);
      dst[xx * 3 + 2] = clamp8(b);
    }
  }

  // Vertical pass fused with crop + normalize.
  const int out_w = cs > 0 ? cs : rs_w;
  const int out_h = cs > 0 ? cs : rs_h;
  const int x_off = cs > 0 ? cx : 0;
  const int y_off = cs > 0 ? cy : 0;
  if (x_off < 0 || y_off < 0 || x_off + out_w > rs_w || y_off + out_h > rs_h) return -1;
  const float inv255 = 1.0f / 255.0f;
  for (int yy = 0; yy < out_h; ++yy) {
    const int src_yy = yy + y_off;
    const double* k = &ch_.weights[static_cast<size_t>(src_yy) * ch_.ksize];
    const int y0 = ch_.xmin[src_yy] - ymin_used, n = ch_.xsize[src_yy];
    float* dst = out + static_cast<size_t>(yy) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      const int src_xx = xx + x_off;
      double acc[3] = {0, 0, 0};
      for (int y = 0; y < n; ++y) {
        const uint8_t* p = &tmp[(static_cast<size_t>(y0 + y) * rs_w + src_xx) * 3];
        acc[0] += k[y] * p[0];
        acc[1] += k[y] * p[1];
        acc[2] += k[y] * p[2];
      }
      for (int ch = 0; ch < 3; ++ch) {
        // Pillow clips the resampled value back to uint8 range and rounds;
        // mirror that so numerics match the PIL pipeline.
        double v = acc[ch];
        v = v < 0.0 ? 0.0 : (v > 255.0 ? 255.0 : v);
        v = std::floor(v + 0.5);  // Pillow's fixed-point path rounds half-up
        dst[xx * 3 + ch] = (static_cast<float>(v) * inv255 - mean[ch]) / stdv[ch];
      }
    }
  }
  return 0;
}

}  // extern "C"
