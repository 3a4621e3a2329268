// JPEG decoder for the port's image path (tell_tpu_torch/data/jpeg.py
// binds it with ctypes; g++ builds it at first use).
//
// The output is the RGB image libjpeg-turbo gives with its default decode
// settings (the ones Pillow's Image.open(...).convert("RGB") uses): the
// integer "slow" IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2, the
// post-IDCT range-limit table), "fancy" triangular chroma upsampling
// (jdsample.c, with its biases, its edge columns and the first and last
// component rows repeated as context; other integral factors replicate),
// the fixed-point YCbCr->RGB tables (jdcolor.c, SCALEBITS 16), and for
// four components libjpeg's YCCK->CMYK step followed by Pillow's own
// "CMYK;I" unpacking (Adobe polarity) and CMYK->RGB conversion. The whole
// padded MCU area is decoded, upsampled, converted and then cropped to the
// frame.
//
// Scope: SOF0/SOF1 (sequential) and SOF2 (progressive), 8-bit samples,
// Huffman coding; one component (grey, replicated to RGB), three (YCbCr,
// or RGB when an Adobe marker with transform 0 or the component ids 'R',
// 'G', 'B' say so, as libjpeg decides) or four (CMYK, or YCCK by the Adobe
// transform), each plane at 1x1, 2x1, 2x2, 4x1 or 1x2 of the largest
// (4:4:4, 4:2:2, 4:2:0, 4:1:1, 4:4:0); restart intervals; interleaved or
// one-component scans; APPn and COM skipped. A progressive frame is
// decoded into a whole-frame coefficient buffer (DC first and refinement
// scans, AC first and refinement scans with EOB runs) and transformed at
// EOI; one whose scans leave any of the first ten coefficients unrefined
// is refused, since libjpeg then smooths blocks (jdcoefct.c) and this
// decoder does not. Everything else is refused with a message naming the
// form (status 1); data that ends early or does not decode is status 2. A
// frame of more than kMaxPixels is status 4, before anything is allocated
// for it.
//
// The input is untrusted (the caption service decodes what a request
// sends): every table is checked before it is used to index, a sequential
// scan must hold at least the 2 bits a block takes before its planes are
// allocated, a progressive component's first scan must be a DC scan that
// holds at least the bit a block takes before its coefficient buffer is
// allocated, and data that runs out is caught at the end of the block row
// it runs out in.
//
// C ABI:
//   int tnt_jpeg_info(data, n, info[4], err, errlen)
//     info: height, width, components, 1 for a progressive frame
//   int tnt_jpeg_decode(data, n, out, out_len, err, errlen)
// Both return 0 on success, 1 for a refused form, 2 for corrupt or
// truncated data, 3 when out_len is smaller than H * W * 3, 4 for a frame
// above the pixel limit.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum { kOk = 0, kRefused = 1, kCorrupt = 2, kSmall = 3, kTooLarge = 4 };

// Pillow's decompression-bomb limit: Image.open raises above
// 2 * MAX_IMAGE_PIXELS = 2 * (1024 ** 3 // 4 // 3) pixels
constexpr int64_t kMaxPixels = 178956970;

struct Fail {
  int code;
  std::string msg;
};

[[noreturn]] void refuse(const std::string& what) { throw Fail{kRefused, what}; }
[[noreturn]] void corrupt(const std::string& what) { throw Fail{kCorrupt, what}; }

// zigzag position -> natural (row-major) position
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// libjpeg's jpeg_natural_order with its 16 extra entries of 63: a
// progressive run that overshoots its band lands on coefficient 63 there,
// and so it does here
struct NaturalExt {
  int at[80];
  NaturalExt() {
    for (int i = 0; i < 80; ++i) at[i] = i < 64 ? kNatural[i] : 63;
  }
};
const NaturalExt kNaturalExt;

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  uint16_t look[1 << kLookBits] = {};  // (length << 8) | value; 0: no entry

  void build(const uint8_t counts[17], const uint8_t* v, int nv) {
    std::memcpy(vals, v, nv);
    std::memset(look, 0, sizeof(look));
    int32_t code = 0;
    int p = 0;
    for (int len = 1; len <= 16; ++len) {
      valoffset[len] = p - code;
      for (int i = 0; i < counts[len]; ++i, ++code, ++p) {
        // every code fits in len bits and none is all ones (libjpeg's
        // jpeg_make_d_derived_tbl); checked before it indexes `look`
        if (code + 1 >= (1 << len)) corrupt("a Huffman table with too many codes");
        if (len <= kLookBits) {
          int shift = kLookBits - len;
          for (int f = 0; f < (1 << shift); ++f)
            look[(code << shift) | f] = uint16_t((len << 8) | vals[p]);
        }
      }
      maxcode[len] = counts[len] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;        // table selectors of the current scan
  int pred = 0;              // DC prediction
  int bw = 0, bh = 0;        // blocks per row and column of the padded plane
  int dw = 0, dh = 0;        // samples of the component inside the frame
  bool scanned = false;
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples
  // progressive frames: bw x bh blocks of 64 coefficients (natural order),
  // and each zigzag coefficient's current Al (-1: no scan sent it yet)
  std::vector<int16_t> coef;
  int coef_bits[64];
  Component() { std::fill(coef_bits, coef_bits + 64, -1); }
};

// The entropy-coded segment: bytes after un-stuffing, stopping at a marker.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;
  int64_t real = 0;      // bits taken from the data
  int64_t used = 0;      // bits consumed by the decoder
  bool at_marker = false;

  void reset(const uint8_t* at) {
    p = at;
    acc = 0;
    nbits = 0;
    real = used = 0;
    at_marker = false;
  }

  void fill() {
    while (nbits <= 56) {
      uint32_t b = 0;
      if (!at_marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;   // fill bytes
          if (q < end && *q == 0x00) {
            p = q + 1;                          // stuffed zero
            real += 8;
          } else {
            at_marker = true;                   // p stays on the marker
            b = 0;
          }
        } else {
          ++p;
          real += 8;
        }
      }
      acc |= uint64_t(b) << (56 - nbits);
      nbits += 8;
    }
  }

  inline uint32_t peek(int n) {
    if (nbits < n) fill();
    return uint32_t(acc >> (64 - n));
  }

  inline void skip(int n) {
    acc <<= n;
    nbits -= n;
    used += n;
  }

  inline int get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return int(v);
  }

  int decode(const Huffman& t) {
    uint32_t e = t.look[peek(kLookBits)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    uint32_t bits = peek(16);
    for (int len = kLookBits + 1; len <= 16; ++len) {
      int32_t code = int32_t(bits >> (16 - len));
      if (code <= t.maxcode[len]) {
        skip(len);
        return t.vals[(t.valoffset[len] + code) & 0xFF];
      }
    }
    corrupt("a Huffman code that is in no table");
  }

  // data must have held every bit the decoder consumed
  void check(const char* where) {
    if (used > real) corrupt(std::string("the data ends early (") + where + ")");
  }
  void check_row(const char* what, int row, int rows) {
    if (used > real)
      corrupt("the data ends early (in " + std::string(what) + " " + std::to_string(row + 1) +
              " of " + std::to_string(rows) + ")");
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// --- jidctint.c: jpeg_idct_islow ---------------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// jdmaster.c's prepare_range_limit_table, the post-IDCT part: index & 1023
struct RangeLimit {
  uint8_t idct[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int v = i < 512 ? i : i - 1024;   // the table wraps at +-512
      v += 128;
      idct[i] = uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      int dc = int(int64_t(in[0]) * qt[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) w[r * 8] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * qt[16], z3 = int64_t(in[48]) * qt[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(in[0]) * qt[0];
    z3 = int64_t(in[32]) * qt[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(in[56]) * qt[56];
    tmp1 = int64_t(in[40]) * qt[40];
    tmp2 = int64_t(in[24]) * qt[24];
    tmp3 = int64_t(in[8]) * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits - kPass1Bits;
    w[0] = int(descale(tmp10 + tmp3, s));
    w[56] = int(descale(tmp10 - tmp3, s));
    w[8] = int(descale(tmp11 + tmp2, s));
    w[48] = int(descale(tmp11 - tmp2, s));
    w[16] = int(descale(tmp12 + tmp1, s));
    w[40] = int(descale(tmp12 - tmp1, s));
    w[24] = int(descale(tmp13 + tmp0, s));
    w[32] = int(descale(tmp13 - tmp0, s));
  }
  const uint8_t* lim = kRange.idct;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      uint8_t v = lim[int(descale(w[0], kPass1Bits + 3)) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits + kPass1Bits + 3;
    o[0] = lim[int(descale(tmp10 + tmp3, s)) & 1023];
    o[7] = lim[int(descale(tmp10 - tmp3, s)) & 1023];
    o[1] = lim[int(descale(tmp11 + tmp2, s)) & 1023];
    o[6] = lim[int(descale(tmp11 - tmp2, s)) & 1023];
    o[2] = lim[int(descale(tmp12 + tmp1, s)) & 1023];
    o[5] = lim[int(descale(tmp12 - tmp1, s)) & 1023];
    o[3] = lim[int(descale(tmp13 + tmp0, s)) & 1023];
    o[4] = lim[int(descale(tmp13 - tmp0, s)) & 1023];
  }
}

// --- jdsample.c: the upsamplers ------------------------------------------

// one component plane (dw x dh samples, row stride `stride`) to rh times
// its width and rv times its height: out is (rh*dw) x (rv*dh). 2x1 and 2x2
// interpolate (h2v1/h2v2_fancy_upsample) when the plane is more than 2
// samples wide, 1x2 always (h1v2_fancy_upsample); everything else, and the
// narrow 2x1 and 2x2 planes, replicates (int_upsample, h2v1/h2v2_upsample)
void upsample(const uint8_t* in, int stride, int dw, int dh, int rh, int rv,
              std::vector<uint8_t>& out) {
  const int ow = rh * dw, oh = rv * dh;
  out.assign(size_t(ow) * oh, 0);
  const bool fancy = (rh == 2 && (rv == 1 || rv == 2) && dw > 2) || (rh == 1 && rv == 2);
  for (int r = 0; r < dh; ++r) {
    const uint8_t* row = in + size_t(r) * stride;
    if (!fancy) {
      for (int k = 0; k < rv; ++k) {
        uint8_t* o = out.data() + size_t(rv * r + k) * ow;
        for (int c = 0; c < dw; ++c)
          for (int j = 0; j < rh; ++j) o[rh * c + j] = row[c];
      }
      continue;
    }
    if (rv == 1) {  // h2v1_fancy_upsample
      uint8_t* o = out.data() + size_t(r) * ow;
      int inv = row[0];
      *o++ = uint8_t(inv);
      *o++ = uint8_t((inv * 3 + row[1] + 2) >> 2);
      for (int c = 1; c < dw - 1; ++c) {
        inv = row[c] * 3;
        *o++ = uint8_t((inv + row[c - 1] + 1) >> 2);
        *o++ = uint8_t((inv + row[c + 1] + 2) >> 2);
      }
      inv = row[dw - 1];
      *o++ = uint8_t((inv * 3 + row[dw - 2] + 1) >> 2);
      *o++ = uint8_t(inv);
      continue;
    }
    // h2v2 / h1v2: the row above for the upper output row, the row below
    // for the lower one; the first and last rows are their own context
    for (int k = 0; k < 2; ++k) {
      int nr = k == 0 ? (r > 0 ? r - 1 : 0) : (r + 1 < dh ? r + 1 : dh - 1);
      const uint8_t* in0 = row;
      const uint8_t* in1 = in + size_t(nr) * stride;
      uint8_t* o = out.data() + size_t(2 * r + k) * ow;
      if (rh == 1) {  // h1v2_fancy_upsample
        const int bias = k == 0 ? 1 : 2;
        for (int c = 0; c < dw; ++c) o[c] = uint8_t((in0[c] * 3 + in1[c] + bias) >> 2);
        continue;
      }
      int thiscolsum = in0[0] * 3 + in1[0];
      int nextcolsum = in0[1] * 3 + in1[1];
      *o++ = uint8_t((thiscolsum * 4 + 8) >> 4);
      *o++ = uint8_t((thiscolsum * 3 + nextcolsum + 7) >> 4);
      int lastcolsum = thiscolsum;
      thiscolsum = nextcolsum;
      for (int c = 2; c < dw; ++c) {
        nextcolsum = in0[c] * 3 + in1[c];
        *o++ = uint8_t((thiscolsum * 3 + lastcolsum + 8) >> 4);
        *o++ = uint8_t((thiscolsum * 3 + nextcolsum + 7) >> 4);
        lastcolsum = thiscolsum;
        thiscolsum = nextcolsum;
      }
      *o++ = uint8_t((thiscolsum * 3 + lastcolsum + 8) >> 4);
      *o++ = uint8_t((thiscolsum * 4 + 7) >> 4);
    }
  }
}

// --- jdcolor.c: build_ycc_rgb_table ---------------------------------------

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return int64_t(x * double(int64_t(1) << kScale) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = int((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// --- the decoder ----------------------------------------------------------

// jdapimin.c's default_decompress_parms: what the components hold
enum ColorSpace { kGrey, kYCbCr, kRGB, kCMYK, kYCCK };

// Pillow's MULDIV255 (Convert.c)
inline int muldiv255(int a, int b) {
  int t = a * b + 128;
  return ((t >> 8) + t) >> 8;
}

struct Decoder {
  const uint8_t* data;
  const uint8_t* end;
  const uint8_t* p;
  int width = 0, height = 0;
  int hmax = 1, vmax = 1;
  int restart_interval = 0;
  bool have_frame = false, progressive = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  int scans = 0;
  ColorSpace space = kGrey;
  std::vector<Component> comps;
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {};
  Huffman dc[4], ac[4];

  Decoder(const uint8_t* d, int64_t n) : data(d), end(d + n), p(d) {}

  int u8() {
    if (p >= end) corrupt("the file ends inside a marker segment");
    return *p++;
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // the next marker code; skips fill bytes, and other bytes between
  // segments as libjpeg's next_marker does
  int next_marker() {
    for (;;) {
      while (p < end && *p != 0xFF) ++p;
      while (p < end && *p == 0xFF) ++p;
      if (p >= end) corrupt("the file ends before its EOI marker");
      int m = *p++;
      if (m != 0) return m;
    }
  }

  const uint8_t* segment(int& len) {
    len = u16() - 2;
    if (len < 0 || len > end - p) corrupt("a marker segment runs past the end of the file");
    const uint8_t* s = p;
    p += len;
    return s;
  }

  void read_sof(bool is_progressive) {
    int len;
    const uint8_t* s = segment(len);
    if (have_frame) corrupt("a second frame header");
    if (len < 6) corrupt("a short frame header");
    progressive = is_progressive;
    int precision = s[0];
    height = (s[1] << 8) | s[2];
    width = (s[3] << 8) | s[4];
    int n = s[5];
    if (precision != 8)
      refuse(std::to_string(precision) + "-bit samples");
    if (n != 1 && n != 3 && n != 4) refuse("a " + std::to_string(n) + "-component JPEG");
    if (len < 6 + 3 * n) corrupt("a short frame header");
    if (height == 0) refuse("a JPEG whose height comes in a DNL marker");
    if (width == 0) corrupt("a frame of width 0");
    if (int64_t(width) * height > kMaxPixels)
      throw Fail{kTooLarge, "a frame of " + std::to_string(width) + " x " +
                                std::to_string(height) + " pixels, above the limit of " +
                                std::to_string(kMaxPixels) +
                                " (Pillow's decompression-bomb limit)"};
    comps.resize(n);
    for (int i = 0; i < n; ++i) {
      Component& c = comps[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        corrupt("bad sampling factors or quantisation table in the frame header");
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    if (n > 1) {
      for (const Component& c : comps) {
        int rh = hmax / c.h, rv = vmax / c.v;
        bool ok = hmax % c.h == 0 && vmax % c.v == 0 &&
                  ((rh == 1 && rv == 1) || (rh == 2 && rv == 1) || (rh == 2 && rv == 2) ||
                   (rh == 4 && rv == 1) || (rh == 1 && rv == 2));
        if (!ok) {
          std::string f = "chroma sampling ";
          for (int i = 0; i < n; ++i)
            f += (i ? "," : "") + std::to_string(comps[i].h) + "x" + std::to_string(comps[i].v);
          refuse(f + " (not 4:4:4, 4:2:2, 4:2:0, 4:1:1 or 4:4:0)");
        }
      }
    } else {
      comps[0].h = comps[0].v = hmax = vmax = 1;  // one component: 8x8 MCUs
    }
    int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (Component& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = int((int64_t(height) * c.v + vmax - 1) / vmax);
    }
    have_frame = true;
  }

  void read_dqt() {
    int len;
    const uint8_t* s = segment(len);
    const uint8_t* e = s + len;
    while (s < e) {
      int pq = *s >> 4, tq = *s & 15;
      ++s;
      if (tq > 3 || pq > 1) corrupt("a bad quantisation table header");
      if (e - s < (pq ? 128 : 64)) corrupt("a short quantisation table");
      for (int i = 0; i < 64; ++i) {
        int v = pq ? (s[2 * i] << 8) | s[2 * i + 1] : s[i];
        qt[tq][kNatural[i]] = uint16_t(v);
      }
      s += pq ? 128 : 64;
      qt_defined[tq] = true;
    }
  }

  void read_dht() {
    int len;
    const uint8_t* s = segment(len);
    const uint8_t* e = s + len;
    while (s < e) {
      if (e - s < 17) corrupt("a short Huffman table");
      int tc = *s >> 4, th = *s & 15;
      if (tc > 1 || th > 3) corrupt("a bad Huffman table header");
      uint8_t counts[17] = {};
      int nv = 0;
      for (int i = 1; i <= 16; ++i) nv += counts[i] = s[i];
      s += 17;
      if (nv > 256 || e - s < nv) corrupt("a bad Huffman table");
      (tc ? ac[th] : dc[th]).build(counts, s, nv);
      s += nv;
    }
  }

  void read_app(int marker) {
    int len;
    const uint8_t* s = segment(len);
    if (marker == 0xE0 && len >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) saw_jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = s[11];
    }
  }

  // libjpeg decides the colour space from the markers seen before the
  // first scan
  void latch_color_space() {
    const size_t n = comps.size();
    if (n == 1) {
      space = kGrey;
    } else if (n == 3) {
      space = kYCbCr;
      if (!saw_jfif && saw_adobe && adobe_transform == 0) space = kRGB;
      if (!saw_jfif && !saw_adobe && comps[0].id == 'R' && comps[1].id == 'G' &&
          comps[2].id == 'B')
        space = kRGB;
    } else {
      space = saw_adobe && adobe_transform != 0 ? kYCCK : kCMYK;
    }
  }

  // a DC value: the difference decoded and added to the prediction
  int dc_value(BitReader& br, Component& c) {
    int t = br.decode(dc[c.td]);
    if (t > 11) corrupt("a DC difference of more than 11 bits");
    int diff = t ? extend(br.get(t), t) : 0;
    if ((c.pred >= 0 && diff > INT_MAX - c.pred) || (c.pred < 0 && diff < INT_MIN - c.pred))
      corrupt("a DC value that overflows");  // libjpeg-turbo's JERR_BAD_DCT_COEF
    c.pred += diff;
    return c.pred;
  }

  void decode_block(BitReader& br, Component& c, int bx, int by) {
    int16_t coef[64] = {};
    const Huffman& a = ac[c.ta];
    coef[0] = int16_t(dc_value(br, c));
    for (int k = 1; k < 64;) {
      int rs = br.decode(a);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) corrupt("an AC run past the end of a block");
        coef[kNatural[k]] = int16_t(extend(br.get(s), s));
        ++k;
      } else if (r == 15) {
        k += 16;
      } else {
        break;
      }
    }
    int stride = c.bw * 8;
    idct_islow(coef, qt[c.tq], c.plane.data() + size_t(by) * 8 * stride + size_t(bx) * 8,
               stride);
  }

  // --- jdphuff.c: one block of a progressive scan ------------------------

  struct Scan {
    int ss, se, ah, al;
    int eobrun = 0;
  };

  static int16_t shifted(int v, int al) { return int16_t(uint16_t(unsigned(v) << al)); }

  void progressive_block(BitReader& br, Component& c, int16_t* blk, Scan& sc) {
    if (sc.ss == 0) {  // DC: the first scan's value, or one more bit
      if (sc.ah == 0)
        blk[0] = shifted(dc_value(br, c), sc.al);
      else if (br.get(1))
        blk[0] = int16_t(blk[0] | (1 << sc.al));
      return;
    }
    const Huffman& t = ac[c.ta];
    if (sc.ah == 0) {  // decode_mcu_AC_first
      if (sc.eobrun > 0) {
        --sc.eobrun;
        return;
      }
      for (int k = sc.ss; k <= sc.se; ++k) {
        int rs = br.decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          blk[kNaturalExt.at[k]] = shifted(extend(br.get(s), s), sc.al);
        } else if (r == 15) {
          k += 15;
        } else {
          sc.eobrun = (1 << r) + br.get(r) - 1;
          break;
        }
      }
      return;
    }
    // decode_mcu_AC_refine: a correction bit for every nonzero coefficient
    // passed over, and each new coefficient +-1 << Al
    const int p1 = 1 << sc.al, m1 = -p1;
    auto correct = [&](int16_t& x) {
      if (br.get(1) && (x & p1) == 0) x = int16_t(x + (x >= 0 ? p1 : m1));
    };
    int k = sc.ss;
    if (sc.eobrun == 0) {
      for (; k <= sc.se; ++k) {
        int rs = br.decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;  // libjpeg warns when the size is not 1
        } else if (r != 15) {
          sc.eobrun = (1 << r) + br.get(r);
          break;
        }
        do {
          int16_t& x = blk[kNaturalExt.at[k]];
          if (x != 0)
            correct(x);
          else if (--r < 0)
            break;
          ++k;
        } while (k <= sc.se);
        if (s) blk[kNaturalExt.at[k]] = int16_t(s);
      }
    }
    if (sc.eobrun > 0) {
      for (; k <= sc.se; ++k) {
        int16_t& x = blk[kNatural[k]];
        if (x != 0) correct(x);
      }
      --sc.eobrun;
    }
  }

  void read_restart(BitReader& br, int& next_rst, Scan& scan) {
    br.check("before a restart marker");
    // the reader stops on a marker, or just before it when its buffer filled
    const uint8_t* q = br.p;
    if (q >= end || *q != 0xFF) corrupt("a restart interval with more data than its MCUs");
    while (q < end && *q == 0xFF) ++q;
    if (q >= end || *q != 0xD0 + next_rst)
      corrupt("a missing or out-of-order restart marker");
    next_rst = (next_rst + 1) & 7;
    br.reset(q + 1);
    for (Component& c : comps) c.pred = 0;
    scan.eobrun = 0;
  }

  // jdphuff.c's start_pass_phuff_decoder: the scan's parameters, the
  // progression it continues, and the coefficient buffers its components
  // need (allocated at a component's first scan, which must be DC-first)
  void start_progressive(const std::vector<Component*>& sc, const Scan& scan, int64_t blocks) {
    const bool dc_band = scan.ss == 0;
    bool bad = dc_band ? scan.se != 0 : (scan.ss > scan.se || scan.se > 63 || sc.size() != 1);
    if (scan.ah != 0 && scan.al != scan.ah - 1) bad = true;
    if (scan.al > 13) bad = true;
    if (bad) corrupt("a progressive scan with bad spectral selection or successive approximation");
    for (Component* c : sc) {
      if (dc_band && scan.ah == 0 && !dc[c->td].defined)
        corrupt("a scan whose Huffman table is not defined");
      if (!dc_band && !ac[c->ta].defined) corrupt("a scan whose Huffman table is not defined");
      if (c->coef.empty()) {
        if (!dc_band || scan.ah != 0)
          corrupt("a progressive scan before its component's first DC scan");
        // a DC code takes at least a bit: refuse data that cannot hold the
        // scan before allocating the coefficients
        if ((end - p) * 8 < blocks) corrupt("the data ends early (too short for its scan)");
        c->coef.assign(size_t(c->bw) * c->bh * 64, 0);
      }
      for (int k = scan.ss; k <= scan.se; ++k) c->coef_bits[k] = scan.al;
    }
  }

  void read_sos() {
    if (!have_frame) corrupt("a scan before the frame header");
    if (scans++ == 0) latch_color_space();
    int len;
    const uint8_t* s = segment(len);
    if (len < 1) corrupt("a short scan header");
    int ns = s[0];
    if (ns < 1 || ns > 4 || len < 4 + 2 * ns) corrupt("a bad scan header");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = s[1 + 2 * i], tables = s[2 + 2 * i];
      Component* found = nullptr;
      for (Component& c : comps)
        if (c.id == id) found = &c;
      if (!found) corrupt("a scan of a component the frame does not have");
      found->td = tables >> 4;
      found->ta = tables & 15;
      if (found->td > 3 || found->ta > 3) corrupt("a scan whose Huffman table is not defined");
      if (!progressive && (!dc[found->td].defined || !ac[found->ta].defined))
        corrupt("a scan whose Huffman table is not defined");
      if (!qt_defined[found->tq]) corrupt("a component whose quantisation table is not defined");
      sc.push_back(found);
    }
    Scan scan{s[1 + 2 * ns], s[2 + 2 * ns], s[3 + 2 * ns] >> 4, s[3 + 2 * ns] & 15};
    if (!progressive && (scan.ss != 0 || scan.se != 63 || scan.ah != 0 || scan.al != 0))
      corrupt("a sequential scan with spectral selection");
    const int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    const int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    int64_t blocks = 0;
    if (ns == 1) {
      blocks = int64_t((sc[0]->dw + 7) / 8) * ((sc[0]->dh + 7) / 8);
    } else {
      for (Component* c : sc) blocks += int64_t(mcux) * mcuy * c->h * c->v;
    }
    if (progressive) {
      start_progressive(sc, scan, blocks);
    } else {
      // a block takes at least 2 bits (a DC code and an EOB): refuse data
      // that cannot hold the scan before allocating its planes
      if ((end - p) * 8 < 2 * blocks) corrupt("the data ends early (too short for its scan)");
      for (Component* c : sc)
        if (c->plane.empty()) c->plane.assign(size_t(c->bw) * 8 * c->bh * 8, 0);
    }
    for (Component* c : sc) {
      c->pred = 0;
      c->scanned = true;
    }
    BitReader br;
    br.end = end;
    br.reset(p);
    int next_rst = 0;
    auto block = [&](Component& c, int bx, int by) {
      if (progressive)
        progressive_block(br, c, c.coef.data() + (size_t(by) * c.bw + bx) * 64, scan);
      else
        decode_block(br, c, bx, by);
    };
    if (ns == 1) {  // one component: its blocks inside the frame, row by row
      Component& c = *sc[0];
      int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
      int64_t count = 0;
      for (int by = 0; by < nby; ++by) {
        for (int bx = 0; bx < nbx; ++bx) {
          if (restart_interval && count && count % restart_interval == 0)
            read_restart(br, next_rst, scan);
          block(c, bx, by);
          ++count;
        }
        br.check_row("block row", by, nby);
      }
    } else {
      int64_t count = 0;
      for (int my = 0; my < mcuy; ++my) {
        for (int mx = 0; mx < mcux; ++mx) {
          if (restart_interval && count && count % restart_interval == 0)
            read_restart(br, next_rst, scan);
          for (Component* c : sc)
            for (int v = 0; v < c->v; ++v)
              for (int h = 0; h < c->h; ++h) block(*c, mx * c->h + h, my * c->v + v);
          ++count;
        }
        br.check_row("MCU row", my, mcuy);
      }
    }
    p = br.p;
  }

  // a progressive frame's coefficients through the IDCT once every scan is
  // in (jdcoefct.c's decompress_data; decompress_smooth_data is refused)
  void finish_progressive() {
    bool smoothing = true;  // smoothing_ok: the first ten quantisers nonzero
    for (const Component& c : comps) {
      if (c.coef.empty()) corrupt("a component that no scan decoded");
      const uint16_t* q = qt[c.tq];
      for (int pos : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
        if (q[pos] == 0) smoothing = false;
    }
    bool useful = false;
    for (const Component& c : comps)
      for (int k = 1; k < 10; ++k) useful |= c.coef_bits[k] != 0;
    if (smoothing && useful)
      refuse("a progressive JPEG whose scans leave some of the first ten coefficients "
             "unrefined (libjpeg smooths such blocks)");
    for (Component& c : comps) {
      const int stride = c.bw * 8;
      c.plane.assign(size_t(stride) * c.bh * 8, 0);
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(c.coef.data() + (size_t(by) * c.bw + bx) * 64, qt[c.tq],
                     c.plane.data() + size_t(by) * 8 * stride + size_t(bx) * 8, stride);
      std::vector<int16_t>().swap(c.coef);
    }
  }

  void header() {
    if (end - data < 2 || data[0] != 0xFF || data[1] != 0xD8) {
      if (end - data >= 8 && std::memcmp(data, "\x89PNG\r\n\x1a\n", 8) == 0)
        refuse("a PNG image");
      refuse("a file that is not a JPEG (no SOI marker)");
    }
    p = data + 2;
  }

  // reads markers up to the frame header (info) or to EOI (decode)
  void run(bool info_only) {
    header();
    for (;;) {
      int m = next_marker();
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          read_sof(m == 0xC2);
          if (info_only) return;
          break;
        case 0xC3: refuse("a lossless JPEG (SOF3)");
        case 0xC5: case 0xC6: case 0xC7:
          refuse("a hierarchical JPEG");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          refuse("an arithmetic-coded JPEG");
        case 0xC8: refuse("a JPEG with the reserved JPG marker");
        case 0xC4: read_dht(); break;
        case 0xCC: refuse("an arithmetic-coded JPEG (DAC marker)");
        case 0xDB: read_dqt(); break;
        case 0xDD: {
          int len;
          const uint8_t* s = segment(len);
          if (len < 2) corrupt("a short DRI segment");
          restart_interval = (s[0] << 8) | s[1];
          break;
        }
        case 0xDA:
          read_sos();
          break;
        case 0xD9:
          if (!have_frame) corrupt("no frame header before EOI");
          if (progressive) finish_progressive();
          return;
        case 0xDC: refuse("a JPEG with a DNL marker");
        case 0xD8: corrupt("a second SOI marker");
        default:
          if (m >= 0xD0 && m <= 0xD7) corrupt("a restart marker outside a scan");
          if (m >= 0xE0 && m <= 0xEF) {
            read_app(m);
          } else {
            int len;
            segment(len);  // COM and other segments: skipped
          }
      }
    }
  }

  void output(uint8_t* out) {
    for (const Component& c : comps)
      if (!c.scanned) corrupt("a component that no scan decoded");
    // each plane at full resolution: a pointer and a stride
    const size_t n = comps.size();
    std::vector<uint8_t> up[4];
    const uint8_t* full[4];
    size_t stride[4];
    for (size_t i = 0; i < n; ++i) {
      const Component& c = comps[i];
      const int rh = hmax / c.h, rv = vmax / c.v;
      if (rh == 1 && rv == 1) {
        full[i] = c.plane.data();
        stride[i] = size_t(c.bw) * 8;
      } else {
        upsample(c.plane.data(), c.bw * 8, c.dw, c.dh, rh, rv, up[i]);
        full[i] = up[i].data();
        stride[i] = size_t(rh) * c.dw;
      }
    }
    for (int y = 0; y < height; ++y) {
      const uint8_t* P[4];
      for (size_t i = 0; i < n; ++i) P[i] = full[i] + y * stride[i];
      uint8_t* o = out + size_t(y) * width * 3;
      for (int x = 0; x < width; ++x, o += 3) {
        switch (space) {
          case kGrey:
            o[0] = o[1] = o[2] = P[0][x];
            break;
          case kRGB:
            o[0] = P[0][x], o[1] = P[1][x], o[2] = P[2][x];
            break;
          case kYCbCr: {
            int yy = P[0][x], cb = P[1][x], cr = P[2][x];
            o[0] = clamp255(yy + kYcc.cr_r[cr]);
            o[1] = clamp255(yy + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
            o[2] = clamp255(yy + kYcc.cb_b[cb]);
            break;
          }
          default: {
            int cmy[3], k = P[3][x];
            if (space == kYCCK) {  // jdcolor.c's ycck_cmyk_convert
              int yy = P[0][x], cb = P[1][x], cr = P[2][x];
              cmy[0] = clamp255(255 - (yy + kYcc.cr_r[cr]));
              cmy[1] = clamp255(255 - (yy + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)));
              cmy[2] = clamp255(255 - (yy + kYcc.cb_b[cb]));
            } else {
              cmy[0] = P[0][x], cmy[1] = P[1][x], cmy[2] = P[2][x];
            }
            // Pillow reads the samples inverted ("CMYK;I") and converts
            // with Convert.c's cmyk2rgb, whose nk is 255 - (255 - k)
            for (int i = 0; i < 3; ++i) o[i] = clamp255(k - muldiv255(255 - cmy[i], k));
          }
        }
      }
    }
  }
};

int report(const Fail& f, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", f.msg.c_str());
  return f.code;
}

}  // namespace

extern "C" {

int tnt_jpeg_info(const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  try {
    Decoder d(data, n);
    d.run(true);
    if (!d.have_frame) corrupt("no frame header");
    info[0] = d.height;
    info[1] = d.width;
    info[2] = int32_t(d.comps.size());
    info[3] = d.progressive;
    return kOk;
  } catch (const Fail& f) {
    return report(f, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Fail{kCorrupt, "out of memory"}, err, errlen);
  }
}

int tnt_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_len,
                    char* err, int errlen) {
  try {
    Decoder d(data, n);
    d.run(false);
    if (out_len < int64_t(d.width) * d.height * 3)
      return report(Fail{kSmall, "output buffer too small"}, err, errlen);
    d.output(out);
    return kOk;
  } catch (const Fail& f) {
    return report(f, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Fail{kCorrupt, "out of memory"}, err, errlen);
  }
}

}  // extern "C"
