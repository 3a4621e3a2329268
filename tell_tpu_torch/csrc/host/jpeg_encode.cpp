// JPEG encoder for the port's dataset build (tell_tpu_torch/data/jpeg.py
// binds it with ctypes; g++ builds it at first use).
//
// The output is, byte for byte, what Pillow writes for an RGB image saved
// as JPEG with no options (Image.save(f, "JPEG")) on its libjpeg-turbo
// build: libjpeg's defaults at quality 75, nothing else. The file holds
// SOI, a JFIF APP0 (version 1.01, no density unit, density 1:1), an
// optional COM (Pillow writes the image's "comment" there), two 8-bit DQTs
// (the standard luminance and chrominance tables scaled to quality 75), a
// baseline SOF0 with Y at 2x2 and Cb, Cr at 1x1 (4:2:0), the four standard
// Huffman tables in the order the scan first needs them (DC0, AC0, DC1,
// AC1), one interleaved scan with no restart markers and EOI.
//
// The arithmetic is libjpeg-turbo's, step by step (its SIMD routines give
// the same numbers as these C ones):
// - rgb_ycc_convert (jccolor.c): fixed point at SCALEBITS 16, Cb and Cr
//   rounded with 0.5 - epsilon;
// - the edges (jcprepct.c, jcsample.c): the last column repeated to the
//   plane's padded width, an odd last row repeated to finish its row pair,
//   and below the frame the component's last (downsampled) row repeated to
//   the MCU row's height;
// - h2v2_downsample (jcsample.c): the mean of a 2x2 square with the bias
//   1, 2, 1, 2, ... along each output row; Y is taken as it is;
// - jpeg_fdct_islow (jfdctint.c): CONST_BITS 13, PASS1_BITS 2, output 8x
//   the orthonormal DCT;
// - quantize (jcdctmgr.c): the divisor 8 q as a 16-bit reciprocal with a
//   rounding correction (compute_reciprocal), the sign put back after;
// - the dummy blocks of a partial MCU (jccoefct.c's compress_data): a
//   block right of the plane or below it has no AC and the previous
//   block's quantised DC;
// - Huffman coding (jchuff.c): DC differences per component, AC runs with
//   ZRL and EOB, 0xFF followed by a stuffed 0x00, the last byte filled
//   with one bits.
//
// C ABI:
//   int tnt_jpeg_encode(rgb, height, width, comment, comment_len,
//                       out, out_cap, out_len)
// rgb: height x width x 3 bytes, row-major. Returns 0 with the file's size
// in *out_len, 1 for a size the format cannot hold (above 65500 a side, as
// libjpeg refuses), 3 when out_cap is too small (*out_len is then the
// capacity that is enough).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zigzag position -> natural (row-major) position
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// JPEG Annex K's tables (jcparam.c), natural order
const int kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jstdhuff.c's tables: code counts by length 1-16, then the symbols
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

constexpr int kQuality = 75;
constexpr int kMaxSide = 65500;          // libjpeg's JPEG_MAX_DIMENSION
constexpr int kScaleBits = 16;           // jccolor.c
constexpr int kConstBits = 13, kPass1Bits = 2;   // jfdctint.c

// jcparam.c's jpeg_add_quant_table at quality 75 (scale 50, baseline)
void scaled_table(const int* basic, int* out) {
  const int scale = kQuality < 50 ? 5000 / kQuality : 200 - kQuality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (long(basic[i]) * scale + 50) / 100;
    out[i] = int(t < 1 ? 1 : t > 255 ? 255 : t);
  }
}

// jcdctmgr.c's compute_reciprocal (16-bit DCTELEM) for one divisor
struct Divisor {
  uint32_t recip, corr, shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);          // flss(divisor) - 1
  int r = 16 + b;
  uint64_t fq = (uint64_t(1) << r) / divisor;
  uint64_t fr = (uint64_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {uint32_t(fq), c, uint32_t(r)};
}

struct HuffCode {
  uint16_t code[256];
  uint8_t size[256];
};

// jchuff.c's jpeg_make_c_derived_tbl
void derive(const uint8_t bits[16], const uint8_t* vals, HuffCode& t) {
  std::memset(&t, 0, sizeof(t));
  uint32_t code = 0;
  int p = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len - 1]; ++i, ++p, ++code) {
      t.code[vals[p]] = uint16_t(code);
      t.size[vals[p]] = uint8_t(len);
    }
    code <<= 1;
  }
}

class Writer {
 public:
  std::vector<uint8_t> out;

  void byte(int b) { out.push_back(uint8_t(b)); }
  void word(int w) {
    byte(w >> 8);
    byte(w & 0xff);
  }
  void bytes(const uint8_t* p, size_t n) { out.insert(out.end(), p, p + n); }

  // entropy-coded bits, most significant first, 0xFF stuffed
  void bits(uint32_t value, int n) {
    acc_ = (acc_ << n) | (value & ((uint32_t(1) << n) - 1));
    nacc_ += n;
    while (nacc_ >= 8) {
      int b = int((acc_ >> (nacc_ - 8)) & 0xff);
      byte(b);
      if (b == 0xff) byte(0);
      nacc_ -= 8;
    }
    acc_ &= (uint64_t(1) << nacc_) - 1;
  }
  // jchuff.c's flush_bits: the partial byte filled with ones
  void flush() {
    if (nacc_ > 0) bits(0x7f, 7);
    acc_ = 0;
    nacc_ = 0;
  }

 private:
  uint64_t acc_ = 0;
  int nacc_ = 0;
};

inline int nbits(int v) { return v ? 32 - __builtin_clz(unsigned(v)) : 0; }

// jfdctint.c's jpeg_fdct_islow, in place
void fdct_islow(int32_t* d) {
  const int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                F0_899 = 7373, F1_175 = 9633, F1_501 = 12299, F1_847 = 15137,
                F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
  auto descale = [](int64_t x, int n) {
    return int32_t((x + (int64_t(1) << (n - 1))) >> n);
  };
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8;        // along a row, then a column
    const int next = pass == 0 ? 8 : 1;
    const int odd_bits = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
    for (int k = 0; k < 8; ++k) {
      int32_t* p = d + k * next;
      int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        p[0] = int32_t((tmp10 + tmp11) * (1 << kPass1Bits));
        p[4 * step] = int32_t((tmp10 - tmp11) * (1 << kPass1Bits));
      } else {
        p[0] = descale(tmp10 + tmp11, kPass1Bits);
        p[4 * step] = descale(tmp10 - tmp11, kPass1Bits);
      }
      int64_t z1 = (tmp12 + tmp13) * F0_541;
      p[2 * step] = descale(z1 + tmp13 * F0_765, odd_bits);
      p[6 * step] = descale(z1 - tmp12 * F1_847, odd_bits);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * F1_175;
      tmp4 *= F0_298;
      tmp5 *= F2_053;
      tmp6 *= F3_072;
      tmp7 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 = z3 * -F1_961 + z5;
      z4 = z4 * -F0_390 + z5;
      p[7 * step] = descale(tmp4 + z1 + z3, odd_bits);
      p[5 * step] = descale(tmp5 + z2 + z4, odd_bits);
      p[3 * step] = descale(tmp6 + z2 + z3, odd_bits);
      p[step] = descale(tmp7 + z1 + z4, odd_bits);
    }
  }
}

// One component's padded plane: `w` x `h` samples, every block of the
// component inside it.
struct Plane {
  int w = 0, h = 0;
  std::vector<uint8_t> s;
  uint8_t at(int y, int x) const { return s[size_t(y) * w + x]; }
};

class Encoder {
 public:
  Encoder(const uint8_t* rgb, int h, int w) : rgb_(rgb), h_(h), w_(w) {
    int lq[64], cq[64];
    scaled_table(kLumaQuant, lq);
    scaled_table(kChromaQuant, cq);
    for (int i = 0; i < 64; ++i) {
      qt_[0][i] = lq[i];
      qt_[1][i] = cq[i];
      div_[0][i] = reciprocal(uint32_t(lq[i]) << 3);
      div_[1][i] = reciprocal(uint32_t(cq[i]) << 3);
    }
    derive(kDcLumaBits, kDcVals, dc_[0]);
    derive(kDcChromaBits, kDcVals, dc_[1]);
    derive(kAcLumaBits, kAcLumaVals, ac_[0]);
    derive(kAcChromaBits, kAcChromaVals, ac_[1]);
  }

  void run(const uint8_t* comment, int comment_len, Writer& out) {
    planes();
    headers(comment, comment_len, out);
    scan(out);
    out.word(0xffd9);                        // EOI
  }

 private:
  const uint8_t* rgb_;
  int h_, w_;
  int qt_[2][64];
  Divisor div_[2][64];
  HuffCode dc_[2], ac_[2];
  Plane y_, cb_, cr_;
  int mcu_cols_ = 0, mcu_rows_ = 0, y_bw_ = 0, y_bh_ = 0;

  // rgb_ycc_convert, the edge copies and h2v2_downsample
  void planes() {
    mcu_cols_ = (w_ + 15) / 16;
    mcu_rows_ = (h_ + 15) / 16;
    y_bw_ = (w_ + 7) / 8;                  // width_in_blocks of Y
    y_bh_ = (h_ + 7) / 8;
    const int64_t half = int64_t(1) << (kScaleBits - 1);
    const int64_t cbcr_offset = int64_t(128) << kScaleBits;
    auto fix = [](double x) { return int64_t(x * (1 << kScaleBits) + 0.5); };
    const int64_t ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
    const int64_t rcb = -fix(0.16874), gcb = -fix(0.33126), bcb = fix(0.5);
    const int64_t gcr = -fix(0.41869), bcr = -fix(0.08131);
    // full-size planes, the last column repeated to a multiple of 16 and
    // an odd last row repeated (the conversion buffer's row pair)
    const int fw = mcu_cols_ * 16, fh = h_ + (h_ & 1);
    std::vector<uint8_t> Y(size_t(fw) * fh), Cb(Y.size()), Cr(Y.size());
    for (int y = 0; y < fh; ++y) {
      const uint8_t* row = rgb_ + size_t(y < h_ ? y : h_ - 1) * w_ * 3;
      for (int x = 0; x < fw; ++x) {
        const uint8_t* px = row + size_t(x < w_ ? x : w_ - 1) * 3;
        int64_t r = px[0], g = px[1], b = px[2];
        size_t i = size_t(y) * fw + x;
        Y[i] = uint8_t((ry * r + gy * g + by * b + half) >> kScaleBits);
        Cb[i] = uint8_t((rcb * r + gcb * g + bcb * b + cbcr_offset + half - 1) >> kScaleBits);
        Cr[i] = uint8_t((bcb * r + gcr * g + bcr * b + cbcr_offset + half - 1) >> kScaleBits);
      }
    }
    // Y: y_bw_ blocks wide; rows past the frame repeat its last row
    y_.w = y_bw_ * 8;
    y_.h = mcu_rows_ * 16;
    y_.s.resize(size_t(y_.w) * y_.h);
    for (int y = 0; y < y_.h; ++y)
      std::memcpy(&y_.s[size_t(y) * y_.w], &Y[size_t(y < h_ ? y : h_ - 1) * fw], y_.w);
    // Cb, Cr: each row pair averaged with the bias 1, 2, 1, 2, ...; rows
    // past the last downsampled one repeat it
    const int last = (h_ - 1) / 2;
    for (Plane* p : {&cb_, &cr_}) {
      const std::vector<uint8_t>& src = p == &cb_ ? Cb : Cr;
      p->w = mcu_cols_ * 8;
      p->h = mcu_rows_ * 8;
      p->s.resize(size_t(p->w) * p->h);
      for (int y = 0; y <= last && y < p->h; ++y) {
        const uint8_t* r0 = &src[size_t(2 * y) * fw];
        const uint8_t* r1 = r0 + fw;
        uint8_t* o = &p->s[size_t(y) * p->w];
        for (int x = 0; x < p->w; ++x) {
          int bias = (x & 1) ? 2 : 1;
          o[x] = uint8_t((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
        }
      }
      for (int y = last + 1; y < p->h; ++y)
        std::memcpy(&p->s[size_t(y) * p->w], &p->s[size_t(last) * p->w], p->w);
    }
  }

  void segment(Writer& out, int marker, const uint8_t* body, int n) {
    out.word(marker);
    out.word(n + 2);
    out.bytes(body, size_t(n));
  }

  void dht(Writer& out, int cls_id, const uint8_t bits[16], const uint8_t* vals) {
    int nv = 0;
    for (int i = 0; i < 16; ++i) nv += bits[i];
    std::vector<uint8_t> body;
    body.push_back(uint8_t(cls_id));
    body.insert(body.end(), bits, bits + 16);
    body.insert(body.end(), vals, vals + nv);
    segment(out, 0xffc4, body.data(), int(body.size()));
  }

  void headers(const uint8_t* comment, int comment_len, Writer& out) {
    out.word(0xffd8);                                       // SOI
    const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
    segment(out, 0xffe0, jfif, 14);
    if (comment_len > 0) segment(out, 0xfffe, comment, comment_len);
    for (int t = 0; t < 2; ++t) {                           // DQT
      uint8_t body[65];
      body[0] = uint8_t(t);
      for (int k = 0; k < 64; ++k) body[1 + k] = uint8_t(qt_[t][kNatural[k]]);
      segment(out, 0xffdb, body, 65);
    }
    const uint8_t sof[15] = {8, uint8_t(h_ >> 8), uint8_t(h_), uint8_t(w_ >> 8), uint8_t(w_),
                             3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
    segment(out, 0xffc0, sof, 15);
    dht(out, 0x00, kDcLumaBits, kDcVals);
    dht(out, 0x10, kAcLumaBits, kAcLumaVals);
    dht(out, 0x01, kDcChromaBits, kDcVals);
    dht(out, 0x11, kAcChromaBits, kAcChromaVals);
    const uint8_t sos[10] = {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
    segment(out, 0xffda, sos, 10);
  }

  // forward_DCT: the block at (by, bx) of `p` centred, transformed and
  // quantised with table `t`
  void block(const Plane& p, int by, int bx, int t, int16_t* q) const {
    int32_t d[64];
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x) d[y * 8 + x] = int32_t(p.at(by * 8 + y, bx * 8 + x)) - 128;
    fdct_islow(d);
    for (int i = 0; i < 64; ++i) {
      const Divisor& v = div_[t][i];
      uint32_t a = uint32_t(d[i] < 0 ? -d[i] : d[i]);
      int32_t r = int32_t((uint64_t(a + v.corr) * v.recip) >> v.shift);
      q[i] = int16_t(d[i] < 0 ? -r : r);
    }
  }

  // encode_one_block
  void encode(const int16_t* q, int& pred, int t, Writer& out) const {
    int diff = q[0] - pred;
    pred = q[0];
    int a = diff < 0 ? -diff : diff;
    int n = nbits(a);
    out.bits(dc_[t].code[n], dc_[t].size[n]);
    if (n) out.bits(uint32_t(diff < 0 ? diff - 1 : diff), n);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = q[kNatural[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        out.bits(ac_[t].code[0xf0], ac_[t].size[0xf0]);
        run -= 16;
      }
      a = v < 0 ? -v : v;
      n = nbits(a);
      int sym = (run << 4) + n;
      out.bits(ac_[t].code[sym], ac_[t].size[sym]);
      out.bits(uint32_t(v < 0 ? v - 1 : v), n);
      run = 0;
    }
    if (run > 0) out.bits(ac_[t].code[0], ac_[t].size[0]);
  }

  void scan(Writer& out) {
    int pred[3] = {0, 0, 0};
    int16_t q[4][64];
    for (int my = 0; my < mcu_rows_; ++my) {
      for (int mx = 0; mx < mcu_cols_; ++mx) {
        for (int yi = 0; yi < 2; ++yi) {
          for (int xi = 0; xi < 2; ++xi) {
            int16_t* b = q[yi * 2 + xi];
            int by = my * 2 + yi, bx = mx * 2 + xi;
            if (by < y_bh_ && bx < y_bw_) {
              block(y_, by, bx, 0, b);
            } else {
              // a dummy block: the DC of the block before it in the MCU
              // (to its left, or the last of the row above)
              std::memset(b, 0, sizeof(q[0]));
              b[0] = by < y_bh_ ? q[yi * 2 + xi - 1][0] : q[yi * 2 - 1][0];
            }
          }
        }
        for (int i = 0; i < 4; ++i) encode(q[i], pred[0], 0, out);
        block(cb_, my, mx, 1, q[0]);
        encode(q[0], pred[1], 1, out);
        block(cr_, my, mx, 1, q[0]);
        encode(q[0], pred[2], 1, out);
      }
    }
    out.flush();
  }
};

}  // namespace

extern "C" {

int tnt_jpeg_encode(const uint8_t* rgb, int32_t height, int32_t width, const uint8_t* comment,
                    int32_t comment_len, uint8_t* out, int64_t out_cap, int64_t* out_len) {
  if (height < 1 || width < 1 || height > kMaxSide || width > kMaxSide || comment_len < 0 ||
      comment_len > 65533)
    return 1;
  Writer w;
  w.out.reserve(size_t(height) * width / 2 + 1024);
  Encoder(rgb, height, width).run(comment, comment_len, w);
  *out_len = int64_t(w.out.size());
  if (*out_len > out_cap) return 3;
  std::memcpy(out, w.out.data(), w.out.size());
  return 0;
}

}  // extern "C"
