// PNG scanlines to RGB for the port's image path (tell_tpu_torch/data/
// png.py parses the chunks, checks their CRCs and inflates the IDAT stream
// with zlib, then calls this through ctypes; g++ builds it at first use).
//
// The output is what Pillow's Image.open(...).convert("RGB") gives: the
// five filters (None, Sub, Up, Average, Paeth) undone per scanline, Adam7
// passes put back in place, and samples of 1, 2, 4, 8 or 16 bits expanded
// as Pillow's modes do it: grey of 1 bit to 0/255 (mode "1"), of 2 and 4
// bits scaled to 0..255 (x85, x17), of 16 bits CLIPPED to 255 (mode
// "I;16", whose conversion to RGB clips rather than scales); 16-bit RGB,
// grey+alpha and RGBA keep each sample's high byte; a palette index past
// the PLTE entries is black; alpha and tRNS are dropped, and neither gamma
// nor an ICC profile is applied.
//
// The input is untrusted: the raw buffer is checked to hold every
// scanline before its filter is undone, and the colour type and bit depth
// to be a pair PNG allows.
//
// C ABI:
//   int tnt_png_decode(raw, n, width, height, depth, color_type, interlace,
//                      palette, n_palette, out, out_len, err, errlen)
// raw holds the inflated IDAT stream; palette n_palette RGB triples. It
// returns 0 on success, 1 for a colour type and depth PNG does not
// define, 2 for data too short or a filter type above 4, 3 when out_len
// is smaller than H * W * 3.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum { kOk = 0, kRefused = 1, kCorrupt = 2, kSmall = 3 };

struct Fail {
  int code;
  std::string msg;
};

int channels_of(int color_type) {
  switch (color_type) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

bool depth_allowed(int color_type, int depth) {
  switch (color_type) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

struct Image {
  int width, height, depth, ctype;
  const uint8_t* palette;
  int npal;
  uint8_t* out;

  // sample i of an unfiltered row (depth < 8: packed from the high bits)
  int sample(const uint8_t* row, int i) const {
    if (depth == 8) return row[i];
    if (depth == 16) return (row[2 * i] << 8) | row[2 * i + 1];
    const int per = 8 / depth, shift = 8 - depth * (i % per + 1);
    return (row[i / per] >> shift) & ((1 << depth) - 1);
  }

  void put(const uint8_t* row, int i, int x, int y) const {
    uint8_t* o = out + (size_t(y) * width + x) * 3;
    const int ch = channels_of(ctype);
    auto hi = [&](int c) { return depth == 16 ? row[2 * (i * ch + c)] : row[i * ch + c]; };
    switch (ctype) {
      case 0: {
        int v = sample(row, i);
        if (depth == 1) v = v ? 255 : 0;
        else if (depth == 2) v *= 85;
        else if (depth == 4) v *= 17;
        else if (depth == 16) v = v > 255 ? 255 : v;
        o[0] = o[1] = o[2] = uint8_t(v);
        break;
      }
      case 3: {
        int v = sample(row, i);
        if (v < npal) std::memcpy(o, palette + 3 * v, 3);
        else o[0] = o[1] = o[2] = 0;
        break;
      }
      case 4:
        o[0] = o[1] = o[2] = hi(0);
        break;
      default:  // 2 and 6
        o[0] = hi(0), o[1] = hi(1), o[2] = hi(2);
    }
  }
};

// one pass of pw x ph pixels at (x0 + i*dx, y0 + r*dy); returns the raw
// bytes it took
int64_t pass(const Image& im, const uint8_t* raw, int64_t n, int pw, int ph, int x0, int y0,
             int dx, int dy) {
  if (pw == 0 || ph == 0) return 0;  // an empty pass has no scanlines
  const int bits = channels_of(im.ctype) * im.depth;
  const int64_t rowbytes = (int64_t(pw) * bits + 7) / 8;
  const int bpp = bits >= 8 ? bits / 8 : 1;
  if (n < (rowbytes + 1) * ph) throw Fail{kCorrupt, "the image data ends early"};
  std::vector<uint8_t> prev(rowbytes, 0), cur(rowbytes);
  for (int r = 0; r < ph; ++r) {
    const uint8_t* line = raw + (rowbytes + 1) * r;
    const int filter = line[0];
    ++line;
    for (int64_t i = 0; i < rowbytes; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0, b = prev[i], c = i >= bpp ? prev[i - bpp] : 0;
      int pred;
      switch (filter) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: throw Fail{kCorrupt, "a scanline filter type of " + std::to_string(filter)};
      }
      cur[i] = uint8_t(line[i] + pred);
    }
    for (int i = 0; i < pw; ++i) im.put(cur.data(), i, x0 + i * dx, y0 + r * dy);
    prev.swap(cur);
  }
  return (rowbytes + 1) * ph;
}

}  // namespace

extern "C" {

int tnt_png_decode(const uint8_t* raw, int64_t n, int32_t width, int32_t height, int depth,
                   int color_type, int interlace, const uint8_t* palette, int n_palette,
                   uint8_t* out, int64_t out_len, char* err, int errlen) {
  try {
    if (!depth_allowed(color_type, depth))
      throw Fail{kRefused, "colour type " + std::to_string(color_type) + " at " +
                               std::to_string(depth) + " bits"};
    if (width <= 0 || height <= 0) throw Fail{kCorrupt, "an image of zero size"};
    if (out_len < int64_t(width) * height * 3) throw Fail{kSmall, "output buffer too small"};
    Image im{width, height, depth, color_type, palette, n_palette, out};
    if (!interlace) {
      pass(im, raw, n, width, height, 0, 0, 1, 1);
    } else {
      static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                       {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
      int64_t at = 0;
      for (const auto& p : kAdam7) {
        const int pw = width > p[0] ? (width - p[0] + p[2] - 1) / p[2] : 0;
        const int ph = height > p[1] ? (height - p[1] + p[3] - 1) / p[3] : 0;
        at += pass(im, raw + at, n - at, pw, ph, p[0], p[1], p[2], p[3]);
      }
    }
    return kOk;
  } catch (const Fail& f) {
    if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", f.msg.c_str());
    return f.code;
  } catch (const std::bad_alloc&) {
    if (err && errlen > 0) std::snprintf(err, size_t(errlen), "out of memory");
    return kCorrupt;
  }
}

}  // extern "C"
