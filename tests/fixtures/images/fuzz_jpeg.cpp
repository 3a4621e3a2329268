// Mutation fuzzer for the port's JPEG decoder, built with the decoder's
// source under AddressSanitizer and UBSan by tests/test_torch_jpeg.py:
//   g++ -fsanitize=address,undefined -DJPEG_SRC='"<path>/jpeg.cpp"' ...
//   ./fuzz_jpeg ITERATIONS SEED FILE...
// Each file is decoded as it is, then ITERATIONS times with random edits
// (bytes set or flipped anywhere or in the headers, the data cut short, a
// Huffman table's codes moved from one length to another, a progressive
// scan header's Ss/Se/Ah/Al byte changed). A sanitizer
// report or a crash fails the run; refusals are expected and counted.
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <iterator>
#include <memory>
#include <random>
#include <vector>

#include JPEG_SRC

static int decode(const std::vector<uint8_t>& d) {
  char err[256];
  int32_t hw[4];
  int code = tnt_jpeg_info(d.data(), int64_t(d.size()), hw, err, sizeof err);
  if (code) return code;
  // a frame over 64 MiB gets a 1-byte buffer: the whole decode still runs
  // and then reports it too small (ASan's shadow of a big buffer is slow)
  size_t n = size_t(hw[0]) * hw[1] * 3;
  if (n > (size_t(1) << 26)) n = 1;
  std::unique_ptr<uint8_t[]> out(new uint8_t[n]);
  return tnt_jpeg_decode(d.data(), int64_t(d.size()), out.get(), int64_t(n), err, sizeof err);
}

int main(int argc, char** argv) {
  if (argc < 4) return 2;
  const long iters = std::atol(argv[1]);
  std::mt19937_64 rng(std::strtoull(argv[2], nullptr, 10));
  std::vector<std::vector<uint8_t>> seeds;
  for (int i = 3; i < argc; ++i) {
    std::ifstream f(argv[i], std::ios::binary);
    seeds.emplace_back(std::istreambuf_iterator<char>(f), std::istreambuf_iterator<char>());
    std::printf("%s: status %d\n", argv[i], decode(seeds.back()));
  }
  long decoded = 0;
  for (long it = 0; it < iters; ++it) {
    std::vector<uint8_t> d = seeds[rng() % seeds.size()];
    std::vector<size_t> dht;  // offsets of the DHT segments' count bytes
    std::vector<size_t> sos;  // offsets of the scan headers' last 3 bytes
    for (size_t i = 0; i + 21 < d.size(); ++i) {
      if (d[i] == 0xFF && d[i + 1] == 0xC4) dht.push_back(i + 5);
      if (d[i] == 0xFF && d[i + 1] == 0xDA) {
        const size_t len = (size_t(d[i + 2]) << 8) | d[i + 3];
        if (len >= 6 && i + 2 + len <= d.size()) sos.push_back(i + 2 + len - 3);
      }
    }
    const int edits = 1 + int(rng() % 6);
    for (int e = 0; e < edits && !d.empty(); ++e) {
      const size_t at = rng() % d.size();
      switch (rng() % 6) {
        case 0: d[at] = uint8_t(rng()); break;
        case 1: d[at % 640] = uint8_t(rng()); break;
        case 2: d[at] ^= uint8_t(1u << (rng() % 8)); break;
        case 3: d.resize(at + 1); dht.clear(); sos.clear(); break;
        case 4:  // Ss, Se or Ah/Al of a scan
          if (!sos.empty()) d[sos[rng() % sos.size()] + rng() % 3] = uint8_t(rng() % 80);
          break;
        default:
          if (!dht.empty()) {  // move a length's codes to another length:
            uint8_t* c = &d[dht[rng() % dht.size()]];  // the segment stays whole
            const int from = int(rng() % 16), to = int(rng() % 16);
            const int moved = c[from] < 255 - c[to] ? c[from] : 255 - c[to];
            if (from != to) c[to] = uint8_t(c[to] + moved), c[from] = uint8_t(c[from] - moved);
          }
      }
    }
    decoded += decode(d) == 0;
  }
  std::printf("mutations %ld decoded %ld\n", iters, decoded);
  return 0;
}
