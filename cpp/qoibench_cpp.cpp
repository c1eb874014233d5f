// qoibench-cpp — single-core benchmark of the oracle codec.
// This is the baseline *denominator* for the device engine's speedup numbers
// (reference harness: /root/reference/qoibench.c; metrics per
// qoibench.c:340-357: ms, Mpixels/s, size KB, rate %).
//
// Two modes:
//   qoibench-cpp [runs] [width] [height] [channels]
//     synthetic-image micro-bench (same content mix as the Python bench);
//     prints a table plus one JSON line.
//   qoibench-cpp <runs> <dir> [--nowarmup --noverify --noencode --nodecode
//                              --norecurse --onlytotals --nopng]
//     PNG-corpus mode (reference qoibench.c:491-610): recursively walks
//     *.png, verifies the QOI roundtrip per image (qoibench.c:410-417),
//     benches decode+encode for libpng and the QOI oracle, and prints
//     per-image rows, per-directory totals and a grand total.

#include <dirent.h>
#include <sys/stat.h>

#include <algorithm>
#include <chrono>
#include <cinttypes>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "png_io.hpp"
#include "qoi_oracle.hpp"

namespace {

double now_ms() {
  using clock = std::chrono::steady_clock;
  return std::chrono::duration<double, std::milli>(
             clock::now().time_since_epoch())
      .count();
}

// Deterministic xorshift so C++ and Python benches agree on content class.
uint32_t xorshift(uint32_t& s) {
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  return s;
}

std::vector<uint8_t> synth_image(uint32_t w, uint32_t h, int ch) {
  std::vector<uint8_t> px(size_t(w) * h * ch);
  uint32_t seed = 0x9e3779b9u;
  for (uint32_t y = 0; y < h; ++y) {
    for (uint32_t x = 0; x < w; ++x) {
      uint8_t* p = px.data() + (size_t(y) * w + x) * ch;
      const int region = (x * 4 / w);
      if (region == 0) {  // smooth gradient: DIFF/LUMA territory
        p[0] = uint8_t(x + y);
        p[1] = uint8_t(x);
        p[2] = uint8_t(y);
      } else if (region == 1) {  // flat: RUN territory
        p[0] = 40;
        p[1] = 80;
        p[2] = 120;
      } else if (region == 2) {  // banded: INDEX territory
        const int band = (x / 3) % 8;
        p[0] = uint8_t(10 * band);
        p[1] = uint8_t(20 * band);
        p[2] = uint8_t(30 * band);
      } else {  // noise: RGB/RGBA territory
        const uint32_t r = xorshift(seed);
        p[0] = uint8_t(r);
        p[1] = uint8_t(r >> 8);
        p[2] = uint8_t(r >> 16);
      }
      if (ch == 4) p[3] = uint8_t(x % 64 == 0 ? 200 : 255);
    }
  }
  return px;
}

int synthetic_main(int runs, uint32_t w, uint32_t h, int ch) {
  const qoi_oracle::ImageDesc desc{w, h, uint8_t(ch), 0};
  std::vector<uint8_t> pixels = synth_image(w, h, ch);
  const double mpx = double(w) * h / 1e6;

  // Roundtrip verification first (the reference's only correctness check,
  // qoibench.c:410-417).
  std::vector<uint8_t> enc = qoi_oracle::encode(pixels.data(), desc);
  qoi_oracle::ImageDesc d2;
  std::vector<uint8_t> dec = qoi_oracle::decode(enc.data(), enc.size(), d2, ch);
  if (dec != pixels) {
    std::fprintf(stderr, "FAIL: roundtrip mismatch\n");
    return 1;
  }

  double enc_ms = 0, dec_ms = 0;
  for (int i = -1; i < runs; ++i) {  // run -1 is the discarded warmup
    double t0 = now_ms();
    std::vector<uint8_t> e = qoi_oracle::encode(pixels.data(), desc);
    double t1 = now_ms();
    qoi_oracle::ImageDesc dd;
    std::vector<uint8_t> p = qoi_oracle::decode(e.data(), e.size(), dd, ch);
    double t2 = now_ms();
    if (i >= 0) {
      enc_ms += (t1 - t0) / runs;
      dec_ms += (t2 - t1) / runs;
    }
  }

  std::printf("## qoibench-cpp %ux%u ch=%d, %d runs\n", w, h, ch, runs);
  std::printf("        decode ms   encode ms   decode mpps   encode mpps   "
              "size kb    rate\n");
  std::printf("oracle  %9.3f   %9.3f   %11.3f   %11.3f   %7zu   %4.1f%%\n",
              dec_ms, enc_ms, mpx / (dec_ms / 1000.0),
              mpx / (enc_ms / 1000.0), enc.size() / 1024,
              100.0 * double(enc.size()) / (double(pixels.size()) + 14));
  std::printf("{\"encode_mpps\": %.3f, \"decode_mpps\": %.3f, "
              "\"bytes\": %zu, \"rate\": %.4f}\n",
              mpx / (enc_ms / 1000.0), mpx / (dec_ms / 1000.0), enc.size(),
              double(enc.size()) / double(pixels.size()));
  return 0;
}

// ---- corpus mode -----------------------------------------------------------

struct Options {
  int runs = 1;
  bool warmup = true, verify = true, encode = true, decode = true;
  bool recurse = true, onlytotals = false, png = true;
};

struct Result {
  int count = 0;
  uint64_t px = 0, raw = 0;
  uint64_t qoi_bytes = 0, png_bytes = 0;
  double qoi_enc_ms = 0, qoi_dec_ms = 0, png_enc_ms = 0, png_dec_ms = 0;
};

void print_result(const char* name, const Result& r, const Options& opt) {
  if (!r.count) return;
  const double mpx = double(r.px) / 1e6;
  std::printf("## %s — %d images, %.1f Mpx total\n", name, r.count, mpx);
  std::printf("          decode ms   encode ms   decode mpps   encode mpps"
              "   size kb    rate\n");
  if (opt.png) {
    std::printf("libpng  %11.3f %11.3f   %11.3f   %11.3f %9" PRIu64
                "   %4.1f%%\n",
                r.png_dec_ms, r.png_enc_ms,
                r.png_dec_ms > 0 ? mpx / (r.png_dec_ms / 1000.0) : 0.0,
                r.png_enc_ms > 0 ? mpx / (r.png_enc_ms / 1000.0) : 0.0,
                r.png_bytes / 1024, 100.0 * double(r.png_bytes) / r.raw);
  }
  std::printf("qoi     %11.3f %11.3f   %11.3f   %11.3f %9" PRIu64
              "   %4.1f%%\n\n",
              r.qoi_dec_ms, r.qoi_enc_ms,
              r.qoi_dec_ms > 0 ? mpx / (r.qoi_dec_ms / 1000.0) : 0.0,
              r.qoi_enc_ms > 0 ? mpx / (r.qoi_enc_ms / 1000.0) : 0.0,
              r.qoi_bytes / 1024, 100.0 * double(r.qoi_bytes) / r.raw);
}

void accumulate(Result& into, const Result& r) {
  into.count += r.count;
  into.px += r.px;
  into.raw += r.raw;
  into.qoi_bytes += r.qoi_bytes;
  into.png_bytes += r.png_bytes;
  into.qoi_enc_ms += r.qoi_enc_ms;
  into.qoi_dec_ms += r.qoi_dec_ms;
  into.png_enc_ms += r.png_enc_ms;
  into.png_dec_ms += r.png_dec_ms;
}

template <typename F>
double bench_fn(F f, const Options& opt) {
  if (opt.warmup) f();
  double best = 1e30;
  for (int i = 0; i < opt.runs; ++i) {
    const double t0 = now_ms();
    f();
    best = std::min(best, now_ms() - t0);
  }
  return best;
}

bool bench_image(const std::string& path, const Options& opt, Result& out) {
  std::vector<uint8_t> pixels;
  uint32_t w = 0, h = 0;
  int ch = 0;
  if (!png_io::load_file(path.c_str(), pixels, w, h, ch)) {
    std::fprintf(stderr, "skip (unreadable png): %s\n", path.c_str());
    return false;
  }
  const qoi_oracle::ImageDesc desc{w, h, uint8_t(ch), 0};
  std::vector<uint8_t> qoi = qoi_oracle::encode(pixels.data(), desc);
  if (qoi.empty()) {
    std::fprintf(stderr, "skip (encode rejected): %s\n", path.c_str());
    return false;
  }
  if (opt.verify) {  // qoibench.c:410-417 — the only correctness check
    qoi_oracle::ImageDesc dd;
    std::vector<uint8_t> back =
        qoi_oracle::decode(qoi.data(), qoi.size(), dd, ch);
    if (back != pixels) {
      std::fprintf(stderr, "FAIL: roundtrip mismatch on %s\n", path.c_str());
      std::exit(1);
    }
  }

  Result r;
  r.count = 1;
  r.px = uint64_t(w) * h;
  r.raw = pixels.size();
  r.qoi_bytes = qoi.size();

  if (opt.decode) {
    r.qoi_dec_ms = bench_fn(
        [&] {
          qoi_oracle::ImageDesc dd;
          volatile auto p = qoi_oracle::decode(qoi.data(), qoi.size(), dd, ch);
          (void)p;
        },
        opt);
  }
  if (opt.encode) {
    r.qoi_enc_ms = bench_fn(
        [&] {
          volatile auto e = qoi_oracle::encode(pixels.data(), desc);
          (void)e;
        },
        opt);
  }
  if (opt.png) {
    std::vector<uint8_t> png;
    if (png_io::encode_mem(pixels.data(), w, h, ch, png)) {
      r.png_bytes = png.size();
      if (opt.decode) {
        r.png_dec_ms = bench_fn(
            [&] {
              std::vector<uint8_t> px2;
              uint32_t w2, h2;
              int ch2;
              png_io::decode_mem(png.data(), png.size(), px2, w2, h2, ch2);
            },
            opt);
      }
      if (opt.encode) {
        r.png_enc_ms = bench_fn(
            [&] {
              std::vector<uint8_t> p2;
              png_io::encode_mem(pixels.data(), w, h, ch, p2);
            },
            opt);
      }
    }
  }

  if (!opt.onlytotals) print_result(path.c_str(), r, opt);
  accumulate(out, r);
  return true;
}

bool has_suffix(const std::string& s, const char* suf) {
  const size_t n = std::strlen(suf);
  return s.size() >= n && s.compare(s.size() - n, n, suf) == 0;
}

void bench_directory(const std::string& dir, const Options& opt,
                     Result& grand) {
  DIR* d = opendir(dir.c_str());
  if (!d) {
    std::fprintf(stderr, "cannot open directory %s\n", dir.c_str());
    return;
  }
  std::vector<std::string> files, subdirs;
  while (dirent* e = readdir(d)) {
    const std::string name = e->d_name;
    if (name == "." || name == "..") continue;
    const std::string full = dir + "/" + name;
    struct stat st;
    if (stat(full.c_str(), &st) != 0) continue;
    if (S_ISDIR(st.st_mode))
      subdirs.push_back(full);
    else if (has_suffix(name, ".png"))
      files.push_back(full);
  }
  closedir(d);
  std::sort(files.begin(), files.end());
  std::sort(subdirs.begin(), subdirs.end());

  if (opt.recurse)
    for (const auto& s : subdirs) bench_directory(s, opt, grand);

  if (files.empty()) return;
  Result dir_total;
  for (const auto& f : files) bench_image(f, opt, dir_total);
  print_result(("total for " + dir).c_str(), dir_total, opt);
  accumulate(grand, dir_total);
}

}  // namespace

int main(int argc, char** argv) {
  // corpus mode: second positional arg is a directory
  struct stat st;
  if (argc >= 3 && stat(argv[2], &st) == 0 && S_ISDIR(st.st_mode)) {
    Options opt;
    opt.runs = std::max(1, std::atoi(argv[1]));
    for (int i = 3; i < argc; ++i) {
      const std::string a = argv[i];
      if (a == "--nowarmup") opt.warmup = false;
      else if (a == "--noverify") opt.verify = false;
      else if (a == "--noencode") opt.encode = false;
      else if (a == "--nodecode") opt.decode = false;
      else if (a == "--norecurse") opt.recurse = false;
      else if (a == "--onlytotals") opt.onlytotals = true;
      else if (a == "--nopng") opt.png = false;
      else {
        std::fprintf(stderr, "unknown flag %s\n", a.c_str());
        return 1;
      }
    }
    Result grand;
    bench_directory(argv[2], opt, grand);
    if (!grand.count) {
      std::fprintf(stderr, "no PNG files under %s\n", argv[2]);
      return 1;
    }
    print_result("GRAND TOTAL", grand, opt);
    const double mpx = double(grand.px) / 1e6;
    std::printf("{\"images\": %d, \"mpx\": %.1f, \"encode_mpps\": %.3f, "
                "\"decode_mpps\": %.3f, \"qoi_rate\": %.4f}\n",
                grand.count, mpx,
                grand.qoi_enc_ms > 0 ? mpx / (grand.qoi_enc_ms / 1000.0) : 0.0,
                grand.qoi_dec_ms > 0 ? mpx / (grand.qoi_dec_ms / 1000.0) : 0.0,
                double(grand.qoi_bytes) / double(grand.raw));
    return 0;
  }

  const int runs = argc > 1 ? std::atoi(argv[1]) : 10;
  const uint32_t w = argc > 2 ? uint32_t(std::atoi(argv[2])) : 1920;
  const uint32_t h = argc > 3 ? uint32_t(std::atoi(argv[3])) : 1080;
  const int ch = argc > 4 ? std::atoi(argv[4]) : 4;
  return synthetic_main(runs, w, h, ch);
}
