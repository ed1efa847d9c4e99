// Native frame-stack reader of viai_tpu_torch (a copy of
// viai_tpu/native/framestack.cpp; viai_tpu_torch/native.py binds it).
//
// The reference decodes video frames with opencv/ffmpeg on the host
// (SURVEY.md §2.1 "Audio-visual dataset"); the rebuild's Python path
// (viai_tpu/data/av.py) does npy/AVI parsing + a per-frame PIL resize,
// which dominates AV item latency. This module moves the whole
// frames-for-clip operation native:
//
//   file (.npy uint8 stack | uncompressed AVI) ──┐
//     temporal window select (linspace, round-half-even == np.round)
//     PIL-compatible triangle-filter resize to (size, size)
//     normalize to float32 [0, 1]
//   ──> caller buffer (n_out, size, size, 3), threaded over frames.
//
// Supported containers (mirrors data/avi.py::read_avi):
//   * .npy v1/v2, dtype |u1, C-order, shape (T, H, W, 3)
//   * RIFF AVI, video stream 'RGBA' 32-bit top-down (write_avi profile)
//     or BI_RGB 24-bit bottom-up padded DIB (ffmpeg rawvideo/bgr24)
// Anything else returns an error code; the port's Python caller
// (viai_tpu_torch/data/av.py) reads float npy stacks in numpy and raises
// for compressed video, naming the layout.
//
// Resize matches Pillow's convolution resampling (BILINEAR): per output
// pixel, center c = (i + 0.5)·scale, support = max(scale, 1), triangle
// weights w(x) = 1 − |x − c + 0.5|/support over the clipped source span,
// normalized. Pillow quantizes the intermediate pass to uint8; we stay
// in float, so outputs agree to ~2/255 (pinned by test).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cfenv>
#include <cmath>
#include <string>
#include <thread>
#include <utility>
#include <vector>

namespace {

struct FrameSource {
  // Either a decoded/owned buffer or a pointer into the file buffer.
  const uint8_t* rgb = nullptr;   // (H, W, 3) row-major top-down
  std::vector<uint8_t> owned;
};

struct Stack {
  std::vector<uint8_t> file;       // whole file
  int64_t T = 0, H = 0, W = 0;
  // npy: frame t starts at base + t*H*W*3
  const uint8_t* npy_base = nullptr;
  // avi: per-frame (payload offset, payload size) into `file`
  std::vector<std::pair<size_t, uint32_t>> avi_frames;
  bool avi_rgba32 = false;         // else DIB24 bottom-up BGR
};

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n <= 0) { std::fclose(f); return false; }
  out.resize((size_t)n);
  size_t got = std::fread(out.data(), 1, (size_t)n, f);
  std::fclose(f);
  return got == (size_t)n;
}

// ---------------------------------------------------------------------
// .npy header: magic, version, header dict "{'descr': '|u1', ...}"
// ---------------------------------------------------------------------
int parse_npy(Stack& s) {
  const auto& b = s.file;
  if (b.size() < 10 || std::memcmp(b.data(), "\x93NUMPY", 6) != 0)
    return -10;
  int major = b[6];
  size_t hlen, hoff;
  if (major == 1) {
    hlen = (size_t)b[8] | ((size_t)b[9] << 8);
    hoff = 10;
  } else {
    if (b.size() < 12) return -10;
    hlen = (size_t)b[8] | ((size_t)b[9] << 8) |
           ((size_t)b[10] << 16) | ((size_t)b[11] << 24);
    hoff = 12;
  }
  if (hoff + hlen > b.size()) return -10;
  std::string h((const char*)b.data() + hoff, hlen);
  if (h.find("'descr': '|u1'") == std::string::npos &&
      h.find("'descr': 'u1'") == std::string::npos &&
      h.find("\"descr\": \"|u1\"") == std::string::npos)
    return -11;                                  // not uint8
  if (h.find("'fortran_order': False") == std::string::npos &&
      h.find("\"fortran_order\": false") == std::string::npos)
    return -12;
  size_t sp = h.find("'shape':");
  if (sp == std::string::npos) sp = h.find("\"shape\":");
  if (sp == std::string::npos) return -10;
  size_t lp = h.find('(', sp);
  size_t rp = h.find(')', sp);
  if (lp == std::string::npos || rp == std::string::npos) return -10;
  std::string tup = h.substr(lp + 1, rp - lp - 1);
  int64_t dims[4] = {0, 0, 0, 0};
  int nd = 0;
  const char* p = tup.c_str();
  while (*p && nd < 4) {
    while (*p == ' ' || *p == ',') ++p;
    if (!*p) break;
    char* end = nullptr;
    long long v = std::strtoll(p, &end, 10);
    if (end == p) break;
    dims[nd++] = (int64_t)v;
    p = end;
  }
  if (nd != 4 || dims[3] != 3) return -13;       // need (T, H, W, 3)
  s.T = dims[0]; s.H = dims[1]; s.W = dims[2];
  size_t need = hoff + hlen + (size_t)(s.T * s.H * s.W * 3);
  if (b.size() < need) return -10;
  s.npy_base = b.data() + hoff + hlen;
  return 0;
}

// ---------------------------------------------------------------------
// AVI: walk RIFF, read vids strf (W, H, bits, compression), collect
// 00dc/00db movi payload offsets. Mirrors data/avi.py::read_avi.
// ---------------------------------------------------------------------
uint32_t rd32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
         ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

int parse_avi(Stack& s) {
  const auto& b = s.file;
  if (b.size() < 12 || std::memcmp(b.data(), "RIFF", 4) != 0 ||
      std::memcmp(b.data() + 8, "AVI ", 4) != 0)
    return -20;
  int32_t bits = 0;
  uint32_t comp = 0;
  bool have_vids = false;
  char last_stream[5] = {0};

  // Iterative chunk walk with an explicit stack of (pos, end).
  std::vector<std::pair<size_t, size_t>> st;
  st.push_back({12, b.size()});
  while (!st.empty()) {
    auto [pos, end] = st.back();
    st.pop_back();
    while (pos + 8 <= end && pos + 8 <= b.size()) {
      const uint8_t* tag = b.data() + pos;
      uint32_t size = rd32(b.data() + pos + 4);
      size_t body = pos + 8;
      if (body + size > b.size()) break;
      if (std::memcmp(tag, "LIST", 4) == 0) {
        // push remainder of this level, then descend
        size_t next = body + size + (size & 1);
        st.push_back({next, end});
        pos = body + 4;
        end = body + size;
        continue;
      } else if (std::memcmp(tag, "strh", 4) == 0 && size >= 4) {
        std::memcpy(last_stream, b.data() + body, 4);
      } else if (std::memcmp(tag, "strf", 4) == 0 &&
                 std::memcmp(last_stream, "vids", 4) == 0 && size >= 20) {
        s.W = (int32_t)rd32(b.data() + body + 4);
        s.H = (int32_t)rd32(b.data() + body + 8);
        bits = (int32_t)(b[body + 14] | (b[body + 15] << 8));
        comp = rd32(b.data() + body + 16);
        have_vids = true;
      } else if ((std::memcmp(tag, "00dc", 4) == 0 ||
                  std::memcmp(tag, "00db", 4) == 0) &&
                 size > 0) {
        s.avi_frames.push_back({body, size});
      }
      pos = body + size + (size & 1);
    }
  }
  if (!have_vids || s.W <= 0 || s.H == 0) return -21;
  uint32_t rgba;
  std::memcpy(&rgba, "RGBA", 4);
  if (comp == rgba && bits == 32) {
    s.avi_rgba32 = true;
  } else if (comp == 0 && bits == 24) {
    // Negative biHeight means a top-down DIB; get_frame decodes DIB24
    // bottom-up only, so report it unsupported rather than
    // silently producing vertically flipped frames (ADVICE r2 low #2).
    if (s.H < 0) return -22;
    s.avi_rgba32 = false;
  } else {
    return -22;                                  // compressed
  }
  if (s.H < 0) s.H = -s.H;                       // top-down sign (RGBA32)
  // Drop truncated frame chunks (e.g. a cut-short file) so get_frame
  // never reads past the payload — mirrors the len() checks in the
  // Python read_avi path this fast path replaces (ADVICE r2 medium #1).
  size_t need = s.avi_rgba32
                    ? (size_t)s.H * s.W * 4
                    : ((size_t)s.W * 3 + 3) / 4 * 4 * (size_t)s.H;
  s.avi_frames.erase(
      std::remove_if(s.avi_frames.begin(), s.avi_frames.end(),
                     [need](const std::pair<size_t, uint32_t>& f) {
                       return (size_t)f.second < need;
                     }),
      s.avi_frames.end());
  s.T = (int64_t)s.avi_frames.size();
  return s.T > 0 ? 0 : -23;
}

// Frame t → (H, W, 3) RGB top-down.
void get_frame(const Stack& s, int64_t t, FrameSource& fs) {
  if (s.npy_base) {
    fs.rgb = s.npy_base + (size_t)t * s.H * s.W * 3;
    return;
  }
  const uint8_t* payload = s.file.data() + s.avi_frames[(size_t)t].first;
  fs.owned.resize((size_t)(s.H * s.W * 3));
  if (s.avi_rgba32) {
    // top-down RGBA rows
    for (int64_t y = 0; y < s.H; ++y) {
      const uint8_t* src = payload + (size_t)y * s.W * 4;
      uint8_t* dst = fs.owned.data() + (size_t)y * s.W * 3;
      for (int64_t x = 0; x < s.W; ++x) {
        dst[x * 3 + 0] = src[x * 4 + 0];
        dst[x * 3 + 1] = src[x * 4 + 1];
        dst[x * 3 + 2] = src[x * 4 + 2];
      }
    }
  } else {
    // bottom-up BGR, rows padded to 4 bytes
    size_t row = ((size_t)s.W * 3 + 3) / 4 * 4;
    for (int64_t y = 0; y < s.H; ++y) {
      const uint8_t* src = payload + (size_t)(s.H - 1 - y) * row;
      uint8_t* dst = fs.owned.data() + (size_t)y * s.W * 3;
      for (int64_t x = 0; x < s.W; ++x) {
        dst[x * 3 + 0] = src[x * 3 + 2];
        dst[x * 3 + 1] = src[x * 3 + 1];
        dst[x * 3 + 2] = src[x * 3 + 0];
      }
    }
  }
  fs.rgb = fs.owned.data();
}

// Pillow-style separable triangle-filter resample coefficients for one
// axis: for each output index, a (first, count) span and normalized
// weights over the source axis.
struct Coeffs {
  std::vector<int> first;
  std::vector<int> count;
  std::vector<float> w;                          // stride = max count
  int stride = 0;
};

Coeffs make_coeffs(int in_size, int out_size) {
  Coeffs c;
  double scale = (double)in_size / out_size;
  double support = scale < 1.0 ? 1.0 : scale;    // triangle support · max(scale,1)
  int kmax = (int)std::ceil(support) * 2 + 1;
  c.first.resize(out_size);
  c.count.resize(out_size);
  c.stride = kmax;
  c.w.assign((size_t)out_size * kmax, 0.0f);
  double ss = 1.0 / (scale < 1.0 ? 1.0 : scale);
  for (int i = 0; i < out_size; ++i) {
    double center = (i + 0.5) * scale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    double total = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      double v = (x - center + 0.5) * ss;
      double t = v < 0 ? -v : v;
      double wt = t < 1.0 ? 1.0 - t : 0.0;
      c.w[(size_t)i * kmax + (x - xmin)] = (float)wt;
      total += wt;
    }
    if (total > 0) {
      for (int x = xmin; x < xmax; ++x)
        c.w[(size_t)i * kmax + (x - xmin)] = (float)(
            c.w[(size_t)i * kmax + (x - xmin)] / total);
    }
    c.first[i] = xmin;
    c.count[i] = xmax - xmin;
  }
  return c;
}

// (H, W, 3) uint8 → (size, size, 3) float32 [0,1], horizontal pass then
// vertical, float intermediate.
void resize_frame(const uint8_t* rgb, int64_t H, int64_t W,
                  const Coeffs& cx, const Coeffs& cy, int size,
                  float* out, std::vector<float>& tmp) {
  tmp.resize((size_t)H * size * 3);
  for (int64_t y = 0; y < H; ++y) {
    const uint8_t* row = rgb + (size_t)y * W * 3;
    float* trow = tmp.data() + (size_t)y * size * 3;
    for (int i = 0; i < size; ++i) {
      float r = 0, g = 0, b = 0;
      int x0 = cx.first[i], n = cx.count[i];
      const float* w = cx.w.data() + (size_t)i * cx.stride;
      for (int k = 0; k < n; ++k) {
        const uint8_t* px = row + (size_t)(x0 + k) * 3;
        r += w[k] * px[0];
        g += w[k] * px[1];
        b += w[k] * px[2];
      }
      trow[i * 3 + 0] = r;
      trow[i * 3 + 1] = g;
      trow[i * 3 + 2] = b;
    }
  }
  const float inv = 1.0f / 255.0f;
  for (int j = 0; j < size; ++j) {
    int y0 = cy.first[j], n = cy.count[j];
    const float* w = cy.w.data() + (size_t)j * cy.stride;
    float* orow = out + (size_t)j * size * 3;
    for (int i = 0; i < size * 3; ++i) {
      float acc = 0;
      for (int k = 0; k < n; ++k)
        acc += w[k] * tmp[(size_t)(y0 + k) * size * 3 + i];
      orow[i] = acc * inv;
    }
  }
}

}  // namespace

extern "C" {

// path → (n_out, size, size, 3) float32 [0,1] into `out`.
// w0/w1: fractional temporal window of the source (see av.py
// _window_indices); indices are round-half-even like np.round.
// Returns 0, or a negative code:
//   -1 io error, -2 unsupported container, -1x npy, -2x avi problems.
int32_t viai_load_frames(const char* path, int32_t n_out, int32_t size,
                         float w0, float w1, float* out) {
  if (n_out <= 0 || size <= 0) return -3;
  Stack s;
  if (!read_file(path, s.file)) return -1;
  int rc;
  size_t len = std::strlen(path);
  bool is_npy = len > 4 && std::memcmp(path + len - 4, ".npy", 4) == 0;
  if (is_npy) rc = parse_npy(s);
  else rc = parse_avi(s);
  if (rc != 0) return rc;
  if (s.T <= 0 || s.H <= 0 || s.W <= 0) return -2;

  // linspace(w0·(T−1), w1·(T−1), n_out).round() — np.round is
  // round-half-even; std::nearbyint honors the default FE_TONEAREST.
  std::vector<int64_t> idx((size_t)n_out);
  double hi = (double)(s.T - 1);
  for (int i = 0; i < n_out; ++i) {
    double f = n_out > 1 ? (double)i / (n_out - 1) : 0.0;
    double v = (w0 + (w1 - w0) * f) * hi;
    int64_t r = (int64_t)std::nearbyint(v);
    if (r < 0) r = 0;
    if (r > s.T - 1) r = s.T - 1;
    idx[(size_t)i] = r;
  }

  Coeffs cx = make_coeffs((int)s.W, size);
  Coeffs cy = make_coeffs((int)s.H, size);

  int hw = (int)std::thread::hardware_concurrency();
  int n_threads = n_out < hw ? n_out : hw;
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  for (int tid = 0; tid < n_threads; ++tid) {
    threads.emplace_back([&, tid]() {
      FrameSource fs;
      std::vector<float> tmp;
      for (int i = tid; i < n_out; i += n_threads) {
        get_frame(s, idx[(size_t)i], fs);
        resize_frame(fs.rgb, s.H, s.W, cx, cy, size,
                     out + (size_t)i * size * size * 3, tmp);
      }
    });
  }
  for (auto& t : threads) t.join();
  return 0;
}

}  // extern "C"
