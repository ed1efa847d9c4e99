// Native host runtime of viai_tpu_torch (a copy of viai_tpu/native/wavio.cpp):
// WAV decode, resample, crop, and a multi-threaded prefetching clip loader.
//
// Reference capability (SURVEY.md §2.4): the reference's host-side
// performance lives in native dependencies — librosa/libsndfile audio
// decode and torch DataLoader worker processes. This library is the
// TPU-rebuild's native equivalent: a C++ decode/crop pipeline with a
// pthread worker pool and a bounded ring of ready batches, bound into
// Python via ctypes (no pybind11 in the image).
//
// Exposed C ABI (viai_tpu_torch/native.py is the Python side; built
// with g++ by viai_tpu_torch/_build.py):
//   viai_decode_wav      — RIFF/WAVE → mono float32 (PCM16/24/32/f32)
//   viai_resample_linear — linear resampler to a target rate
//   viai_loader_create / viai_loader_next / viai_loader_destroy
//                        — threaded random-crop batch loader
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// WAV decode
// ---------------------------------------------------------------------

static uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

// Decode a RIFF/WAVE buffer to mono float32 in [-1, 1].
// Returns number of samples written (<= max_samples), or -1 on error.
// *sr_out receives the sample rate.
int64_t viai_decode_wav(const uint8_t* buf, int64_t len, float* out,
                        int64_t max_samples, int32_t* sr_out) {
  if (len < 44 || memcmp(buf, "RIFF", 4) || memcmp(buf + 8, "WAVE", 4))
    return -1;
  int64_t pos = 12;
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  const uint8_t* data = nullptr;
  uint32_t data_len = 0;
  while (pos + 8 <= len) {
    const uint8_t* hdr = buf + pos;
    uint32_t chunk_len = rd_u32(hdr + 4);
    if (!memcmp(hdr, "fmt ", 4) && pos + 8 + 16 <= len) {
      fmt = rd_u16(hdr + 8);
      channels = rd_u16(hdr + 10);
      sr = rd_u32(hdr + 12);
      bits = rd_u16(hdr + 22);
      if (fmt == 0xFFFE) {
        // WAVE_FORMAT_EXTENSIBLE: the real format code is the first
        // two bytes of the SubFormat GUID at payload offset 24
        // (after cbSize/validBits/channelMask). Extensible float32
        // files were previously mis-decoded as int32 PCM
        // (ADVICE.md round-1 low #4).
        if (chunk_len >= 40 && pos + 8 + 26 <= len)
          fmt = rd_u16(hdr + 8 + 24);
        else
          fmt = 1;  // malformed extension: assume PCM layout
      }
    } else if (!memcmp(hdr, "data", 4)) {
      data = hdr + 8;
      data_len = chunk_len;
      if (pos + 8 + (int64_t)data_len > len) data_len = (uint32_t)(len - pos - 8);
      break;
    }
    pos += 8 + chunk_len + (chunk_len & 1);
  }
  if (!data || !channels || !sr) return -1;
  *sr_out = (int32_t)sr;
  int bytes_per = bits / 8;
  if (bytes_per == 0) return -1;
  int64_t frames = data_len / (bytes_per * channels);
  if (frames > max_samples) frames = max_samples;
  const double inv_ch = 1.0 / channels;
  for (int64_t i = 0; i < frames; i++) {
    double acc = 0.0;
    for (int c = 0; c < channels; c++) {
      const uint8_t* p = data + (i * channels + c) * bytes_per;
      double v = 0.0;
      if (fmt == 3 && bits == 32) {  // IEEE float
        float f;
        memcpy(&f, p, 4);
        v = f;
      } else if (bits == 16) {
        v = (int16_t)rd_u16(p) / 32768.0;
      } else if (bits == 24) {
        int32_t s = (int32_t)((uint32_t)p[0] << 8 | (uint32_t)p[1] << 16 |
                              (uint32_t)p[2] << 24) >> 8;
        v = s / 8388608.0;
      } else if (bits == 32) {
        v = (int32_t)rd_u32(p) / 2147483648.0;
      } else if (bits == 8) {
        v = ((int)p[0] - 128) / 128.0;
      } else {
        return -1;
      }
      acc += v;
    }
    out[i] = (float)(acc * inv_ch);
  }
  return frames;
}

// Linear resample n_in samples at sr_in into n_out samples at sr_out.
void viai_resample_linear(const float* in, int64_t n_in, int32_t sr_in,
                          float* out, int64_t n_out, int32_t sr_out) {
  if (n_in <= 1 || n_out <= 0) return;
  const double step = (double)sr_in / (double)sr_out;
  for (int64_t i = 0; i < n_out; i++) {
    double t = i * step;
    int64_t i0 = (int64_t)t;
    if (i0 >= n_in - 1) i0 = n_in - 2;
    double frac = t - i0;
    out[i] = (float)(in[i0] * (1.0 - frac) + in[i0 + 1] * frac);
  }
}

// ---------------------------------------------------------------------
// Threaded prefetching clip loader
// ---------------------------------------------------------------------
// Worker threads pick random files, decode, resample to target_sr,
// take a random clip_samples crop (zero-pad short files), and push
// assembled (batch, clip_samples) float32 batches into a bounded queue.

struct Loader {
  std::vector<std::string> paths;
  int64_t clip_samples;
  int32_t target_sr;
  int batch;
  uint64_t seed;
  std::atomic<bool> stop{false};
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<std::vector<float>> ready;  // each: batch*clip_samples
  size_t max_queue;
  std::vector<std::thread> workers;
  std::atomic<uint64_t> epoch_counter{0};

  void worker(int wid) {
    std::mt19937_64 rng(seed * 1000003u + wid);
    std::vector<uint8_t> filebuf;
    std::vector<float> decoded, resampled;
    while (!stop.load()) {
      std::vector<float> batch_buf((size_t)batch * clip_samples, 0.0f);
      for (int b = 0; b < batch && !stop.load(); b++) {
        const std::string& path = paths[rng() % paths.size()];
        FILE* f = fopen(path.c_str(), "rb");
        if (!f) continue;
        fseek(f, 0, SEEK_END);
        long fl = ftell(f);
        fseek(f, 0, SEEK_SET);
        filebuf.resize(fl);
        size_t got = fread(filebuf.data(), 1, fl, f);
        fclose(f);
        if ((long)got != fl) continue;
        // Worst case is 8-bit mono: one OUTPUT sample per file byte
        // (fl/2 truncated those files to half their samples —
        // ADVICE.md round-1 low #4).
        decoded.resize(fl + 8);
        int32_t sr = 0;
        int64_t n = viai_decode_wav(filebuf.data(), fl, decoded.data(),
                                    decoded.size(), &sr);
        if (n <= 1) continue;
        const float* src = decoded.data();
        int64_t n_src = n;
        if (sr != target_sr) {
          int64_t n_rs = n * (int64_t)target_sr / sr;
          resampled.resize(n_rs);
          viai_resample_linear(decoded.data(), n, sr, resampled.data(), n_rs,
                               target_sr);
          src = resampled.data();
          n_src = n_rs;
        }
        float* dst = batch_buf.data() + (size_t)b * clip_samples;
        if (n_src >= clip_samples) {
          int64_t start = (int64_t)(rng() % (uint64_t)(n_src - clip_samples + 1));
          memcpy(dst, src + start, clip_samples * sizeof(float));
        } else {
          memcpy(dst, src, n_src * sizeof(float));  // zero-padded tail
        }
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_push.wait(lk, [&] { return ready.size() < max_queue || stop.load(); });
      if (stop.load()) return;
      ready.push_back(std::move(batch_buf));
      cv_pop.notify_one();
    }
  }
};

// paths_blob: '\n'-joined file paths.
void* viai_loader_create(const char* paths_blob, int64_t clip_samples,
                         int32_t target_sr, int32_t batch, int32_t n_workers,
                         int64_t queue_depth, uint64_t seed) {
  Loader* L = new Loader();
  const char* p = paths_blob;
  while (*p) {
    const char* e = strchr(p, '\n');
    if (!e) e = p + strlen(p);
    if (e > p) L->paths.emplace_back(p, e - p);
    p = (*e) ? e + 1 : e;
  }
  if (L->paths.empty()) {
    delete L;
    return nullptr;
  }
  L->clip_samples = clip_samples;
  L->target_sr = target_sr;
  L->batch = batch;
  L->seed = seed;
  L->max_queue = (size_t)queue_depth;
  for (int i = 0; i < n_workers; i++)
    L->workers.emplace_back(&Loader::worker, L, i);
  return L;
}

// Blocks until a batch is ready; copies batch*clip_samples floats into out.
// Returns 0 on success, -1 if the loader is stopped.
int32_t viai_loader_next(void* handle, float* out) {
  Loader* L = (Loader*)handle;
  std::vector<float> buf;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_pop.wait(lk, [&] { return !L->ready.empty() || L->stop.load(); });
    if (L->ready.empty()) return -1;
    buf = std::move(L->ready.front());
    L->ready.pop_front();
    L->cv_push.notify_one();
  }
  memcpy(out, buf.data(), buf.size() * sizeof(float));
  return 0;
}

void viai_loader_destroy(void* handle) {
  Loader* L = (Loader*)handle;
  L->stop.store(true);
  L->cv_push.notify_all();
  L->cv_pop.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
