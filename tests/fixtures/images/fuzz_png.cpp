// Mutation fuzzer for the port's PNG scanline decoder, built with its
// source under AddressSanitizer and UBSan by tests/test_torch_png.py:
//   g++ -fsanitize=address,undefined -DPNG_SRC='"<path>/png.cpp"' ...
//   ./fuzz_png ITERATIONS SEED FILE...
// Each FILE is a case written by the test: a 24-byte header (width,
// height, depth, colour type, interlace, palette entries, as int32) then
// the palette's RGB triples and the inflated IDAT bytes, as data/png.py
// hands them over. Each case is decoded as it is, then ITERATIONS times
// with random edits (raw bytes set or flipped, filter bytes set past 4,
// the data cut short, the header's fields changed to other values PNG
// allows or not). A sanitizer report or a crash fails the run; refusals
// are expected and counted.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <iterator>
#include <memory>
#include <random>
#include <vector>

#include PNG_SRC

struct Case {
  int32_t h[6];
  std::vector<uint8_t> pal, raw;
};

static int decode(const Case& c) {
  char err[256];
  const int64_t w = c.h[0], h = c.h[1];
  if (w <= 0 || h <= 0 || w * h > (int64_t(1) << 22)) return -1;  // as png.py's bounds
  size_t n = size_t(w * h * 3);
  std::unique_ptr<uint8_t[]> out(new uint8_t[n]);
  const int npal = c.h[5] < 0 ? 0 : (c.h[5] * 3 > int(c.pal.size()) ? int(c.pal.size()) / 3 : c.h[5]);
  return tnt_png_decode(c.raw.data(), int64_t(c.raw.size()), c.h[0], c.h[1], c.h[2], c.h[3],
                        c.h[4], c.pal.data(), npal, out.get(), int64_t(n), err, sizeof err);
}

int main(int argc, char** argv) {
  if (argc < 4) return 2;
  const long iters = std::atol(argv[1]);
  std::mt19937_64 rng(std::strtoull(argv[2], nullptr, 10));
  std::vector<Case> seeds;
  for (int i = 3; i < argc; ++i) {
    std::ifstream f(argv[i], std::ios::binary);
    std::vector<uint8_t> b((std::istreambuf_iterator<char>(f)), std::istreambuf_iterator<char>());
    if (b.size() < 24) return 2;
    Case c;
    std::memcpy(c.h, b.data(), 24);
    const size_t np = size_t(c.h[5]) * 3;
    if (24 + np > b.size()) return 2;
    c.pal.assign(b.begin() + 24, b.begin() + 24 + np);
    c.raw.assign(b.begin() + 24 + np, b.end());
    seeds.push_back(c);
    std::printf("%s: status %d\n", argv[i], decode(seeds.back()));
  }
  static const int kDepths[] = {1, 2, 4, 8, 16, 3, 0};
  static const int kTypes[] = {0, 2, 3, 4, 6, 1, 7};
  long decoded = 0;
  for (long it = 0; it < iters; ++it) {
    Case c = seeds[rng() % seeds.size()];
    const int edits = 1 + int(rng() % 4);
    for (int e = 0; e < edits; ++e) {
      const size_t at = c.raw.empty() ? 0 : rng() % c.raw.size();
      switch (rng() % 6) {
        case 0: if (!c.raw.empty()) c.raw[at] = uint8_t(rng()); break;
        case 1: if (!c.raw.empty()) c.raw[at] ^= uint8_t(1u << (rng() % 8)); break;
        case 2: c.raw.resize(at); break;
        case 3: c.h[2] = kDepths[rng() % 7]; break;
        case 4: c.h[3] = kTypes[rng() % 7]; break;
        default:
          if (rng() % 2) c.h[4] ^= 1;
          else c.h[int(rng() % 2)] += int(rng() % 5) - 2;
      }
    }
    decoded += decode(c) == 0;
  }
  std::printf("mutations %ld decoded %ld\n", iters, decoded);
  return 0;
}
