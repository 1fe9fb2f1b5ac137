// tpuvc_torch native host-IO library.
//
// The PyTorch port's copy of tpuvc/native/io.cc: the same three C entries
// with the same ABI.  It keeps the host side of the two IO hot paths off
// the Python interpreter (the reference stack's libsndfile WAV decode and
// TF record-reader queues, SURVEY.md SS2.2/SS2.3 N5):
//   * RIFF/PCM16 WAV decode (mono-ized float32 in [-1, 1])
//   * frame-record loading and shuffled minibatch gather
// Exposed with a plain C ABI for ctypes.
//
// Build: tpuvc_torch/native/__init__.py compiles it with g++ at first use
// (-O3 -std=c++17 -fPIC -shared -lpthread, no -march=native) into
// build/tpuvc_torch_host/ through tpuvc_torch/utils/aot_cache.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Decode a PCM16 RIFF WAV file.  Returns the number of mono samples
// written to out (capacity max_samples), or -1 on error.  Stereo input is
// averaged to mono.  sample_rate_out receives the fs.
int64_t tpuvc_wav_read_pcm16(const char* path, float* out,
                             int64_t max_samples, int32_t* sample_rate_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t hdr[12];
  if (fread(hdr, 1, 12, f) != 12 || memcmp(hdr, "RIFF", 4) ||
      memcmp(hdr + 8, "WAVE", 4)) {
    fclose(f);
    return -1;
  }
  uint16_t channels = 0, bits = 0;
  uint32_t fs = 0;
  int64_t n_out = -1;
  for (;;) {
    uint8_t chunk[8];
    if (fread(chunk, 1, 8, f) != 8) break;
    uint32_t size;
    memcpy(&size, chunk + 4, 4);
    if (!memcmp(chunk, "fmt ", 4)) {
      uint8_t fmt[16];
      if (size < 16 || fread(fmt, 1, 16, f) != 16) break;
      uint16_t tag;
      memcpy(&tag, fmt, 2);
      memcpy(&channels, fmt + 2, 2);
      memcpy(&fs, fmt + 4, 4);
      memcpy(&bits, fmt + 14, 2);
      if (tag != 1 || bits != 16 || channels < 1 || channels > 2) {
        fclose(f);
        return -1;  // only PCM16 mono/stereo
      }
      if (size > 16) fseek(f, size - 16, SEEK_CUR);
    } else if (!memcmp(chunk, "data", 4)) {
      if (channels == 0) {  // data chunk before fmt, or fmt missing:
        fclose(f);          // bail out so the caller's fallback reader runs
        return -1;
      }
      int64_t frames = size / (2 * channels);
      if (frames > max_samples) frames = max_samples;
      std::vector<int16_t> buf(static_cast<size_t>(frames) * channels);
      int64_t got = static_cast<int64_t>(
          fread(buf.data(), 2 * channels, frames, f));
      const float k = 1.0f / 32768.0f;
      if (channels == 1) {
        for (int64_t i = 0; i < got; ++i) out[i] = buf[i] * k;
      } else {
        for (int64_t i = 0; i < got; ++i)
          out[i] = (buf[2 * i] + buf[2 * i + 1]) * (0.5f * k);
      }
      n_out = got;
      break;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  fclose(f);
  if (sample_rate_out) *sample_rate_out = static_cast<int32_t>(fs);
  return n_out;
}

// Read a whole float32 record file into out (capacity max_floats).
// Returns floats read or -1.
int64_t tpuvc_read_f32(const char* path, float* out, int64_t max_floats) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t n = static_cast<int64_t>(fread(out, 4, max_floats, f));
  fclose(f);
  return n;
}

// Parallel row gather: out[i, :] = src[idx[i], :].  The shuffled-minibatch
// assembly hot path (reference: TF shuffle_batch queue threads).
void tpuvc_gather_rows(const float* src, int64_t n_rows, int64_t row_dim,
                       const int64_t* idx, int64_t n_idx, float* out,
                       int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t r = idx[i];
      if (r < 0 || r >= n_rows) {
        memset(out + i * row_dim, 0, sizeof(float) * row_dim);
      } else {
        memcpy(out + i * row_dim, src + r * row_dim,
               sizeof(float) * row_dim);
      }
    }
  };
  if (n_threads == 1 || n_idx < 1024) {
    work(0, n_idx);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (n_idx + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * per;
    int64_t hi = lo + per < n_idx ? lo + per : n_idx;
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& t : ts) t.join();
}

}  // extern "C"
