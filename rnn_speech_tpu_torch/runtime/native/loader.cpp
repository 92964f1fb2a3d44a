// Async audio loader: a native thread pool that decodes, downmixes and
// resamples audio files into an order-preserving bounded queue (a copy of
// the JAX package's runtime/native/loader.cpp, same C ABI).
//
// A Python process pool ships every decoded clip through pickle; here
// workers write float32 PCM straight into buffers the consumer copies out
// via ctypes (runtime/loader.py), so the only Python-side work per clip is
// one memcpy and the label encode.
//
// Container support matches rnn_speech_tpu_torch.audio_io: FLAC (via
// rst_flac_decode from flacdec.cpp), PCM WAV (8/16/24/32-bit), NIST SPHERE
// (8/16-bit PCM).  Resampling is a Kaiser-windowed sinc interpolator (beta
// 5.0, 16 zero crossings per side), the polyphase table that
// audio_io._polyphase_table mirrors tap for tap.
//
// API (all extern "C"):
//   rst_loader_create(n_threads, max_samples, target_rate, capacity) -> handle
//   rst_loader_submit(handle, index, path)      enqueue one file
//   rst_loader_close(handle)                    no more submissions
//   rst_loader_next(handle, &index, out, cap, &n) -> item rc (blocks; -1=end)
//   rst_loader_destroy(handle)

#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" int rst_flac_decode(const char* path, int32_t** out_samples,
                               int64_t* out_count, int32_t* out_channels,
                               int32_t* out_rate, int32_t* out_bps);
extern "C" void rst_free(void* p);

namespace {

// ------------------------------------------------------------- container IO

struct Decoded {
  std::vector<float> mono;  // downmixed [-1, 1]
  int rate = 0;
};

int decode_flac_file(const std::string& path, Decoded* out) {
  int32_t* samples = nullptr;
  int64_t count = 0;
  int32_t channels = 0, rate = 0, bps = 0;
  int rc = rst_flac_decode(path.c_str(), &samples, &count, &channels, &rate, &bps);
  if (rc != 0) return 100 + rc;
  if (rate <= 0 || rate > 1000000 || channels <= 0 || bps < 4 || bps > 32) {
    rst_free(samples);
    return 99;  // corrupt STREAMINFO
  }
  const float scale = 1.0f / (float)(1u << (bps - 1));
  out->mono.resize((size_t)count);
  if (channels == 1) {
    for (int64_t i = 0; i < count; ++i) out->mono[(size_t)i] = samples[i] * scale;
  } else {
    for (int64_t i = 0; i < count; ++i) {
      double acc = 0.0;
      for (int32_t c = 0; c < channels; ++c) acc += samples[i * channels + c];
      out->mono[(size_t)i] = (float)(acc / channels) * scale;
    }
  }
  out->rate = rate;
  rst_free(samples);
  return 0;
}

uint32_t rd_le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_le16(const uint8_t* p) { return (uint16_t)(p[0] | (p[1] << 8)); }

int read_file(const std::string& path, std::vector<uint8_t>* data) {
  FILE* fp = std::fopen(path.c_str(), "rb");
  if (!fp) return 1;
  std::fseek(fp, 0, SEEK_END);
  long n = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  data->resize((size_t)std::max(0L, n));
  if (n > 0 && std::fread(data->data(), 1, (size_t)n, fp) != (size_t)n) {
    std::fclose(fp);
    return 2;
  }
  std::fclose(fp);
  return 0;
}

// PCM WAV: walk RIFF chunks for fmt / data.
int decode_wav(const std::vector<uint8_t>& d, Decoded* out) {
  if (d.size() < 44 || std::memcmp(d.data(), "RIFF", 4) != 0 ||
      std::memcmp(d.data() + 8, "WAVE", 4) != 0)
    return 11;
  size_t pos = 12;
  int channels = 0, rate = 0, bits = 0, fmt = 0;
  const uint8_t* fmt_body = nullptr;
  uint32_t fmt_len = 0;
  const uint8_t* pcm = nullptr;
  size_t pcm_len = 0;
  while (pos + 8 <= d.size()) {
    const uint8_t* hdr = d.data() + pos;
    uint32_t len = rd_le32(hdr + 4);
    const uint8_t* body = hdr + 8;
    if (pos + 8 + len > d.size()) len = (uint32_t)(d.size() - pos - 8);
    if (!std::memcmp(hdr, "fmt ", 4) && len >= 16) {
      fmt = rd_le16(body);
      channels = rd_le16(body + 2);
      rate = (int)rd_le32(body + 4);
      bits = rd_le16(body + 14);
      fmt_body = body;
      fmt_len = len;
    } else if (!std::memcmp(hdr, "data", 4)) {
      pcm = body;
      pcm_len = len;
    }
    pos += 8 + len + (len & 1);
  }
  if (!pcm || channels <= 0 || rate <= 0) return 12;
  if (fmt != 1 && fmt != 0xFFFE) return 13;  // PCM only
  // WAVE_FORMAT_EXTENSIBLE: require a PCM SubFormat (first two GUID bytes).
  if (fmt == 0xFFFE && !(fmt_len >= 40 && rd_le16(fmt_body + 24) == 1))
    return 15;
  if (bits != 8 && bits != 16 && bits != 24 && bits != 32) return 14;
  size_t bytes_per = (size_t)bits / 8;
  size_t frames = pcm_len / (bytes_per * (size_t)channels);
  out->mono.resize(frames);
  for (size_t i = 0; i < frames; ++i) {
    double acc = 0.0;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* s = pcm + (i * channels + c) * bytes_per;
      double v = 0.0;
      switch (bits) {
        case 8:
          v = ((int)s[0] - 128) / 128.0;
          break;
        case 16:
          v = (int16_t)rd_le16(s) / 32768.0;
          break;
        case 24: {
          int32_t x = s[0] | (s[1] << 8) | (s[2] << 16);
          if (x >= (1 << 23)) x -= (1 << 24);
          v = x / 8388608.0;
          break;
        }
        case 32:
          v = (int32_t)rd_le32(s) / 2147483648.0;
          break;
      }
      acc += v;
    }
    out->mono[i] = (float)(acc / channels);
  }
  out->rate = rate;
  return 0;
}

// NIST SPHERE: ASCII header then raw PCM.
int decode_sphere(const std::vector<uint8_t>& d, Decoded* out) {
  if (d.size() < 16 || std::memcmp(d.data(), "NIST_1A", 7) != 0) return 21;
  int header_size = std::atoi(std::string((const char*)d.data() + 8, 8).c_str());
  if (header_size <= 16 || (size_t)header_size > d.size()) return 22;
  std::string head((const char*)d.data() + 16, (size_t)header_size - 16);
  int channels = 1, rate = 16000, n_bytes = 2;
  bool big_endian = false;
  size_t ls = 0;
  while (ls < head.size()) {
    size_t le = head.find('\n', ls);
    if (le == std::string::npos) le = head.size();
    std::string line = head.substr(ls, le - ls);
    ls = le + 1;
    char key[64], typ[16], val[64];
    if (std::sscanf(line.c_str(), "%63s %15s %63s", key, typ, val) == 3) {
      if (!std::strcmp(key, "channel_count")) channels = std::atoi(val);
      else if (!std::strcmp(key, "sample_rate")) rate = std::atoi(val);
      else if (!std::strcmp(key, "sample_n_bytes")) n_bytes = std::atoi(val);
      else if (!std::strcmp(key, "sample_byte_format")) big_endian = !std::strcmp(val, "10");
      else if (!std::strcmp(key, "sample_coding") &&
               (std::strstr(val, "ulaw") || std::strstr(val, "shorten")))
        return 23;  // compressed / companded SPHERE unsupported
    }
  }
  if (channels <= 0 || rate <= 0 || (n_bytes != 1 && n_bytes != 2)) return 24;
  const uint8_t* pcm = d.data() + header_size;
  size_t frames = (d.size() - (size_t)header_size) / ((size_t)n_bytes * channels);
  out->mono.resize(frames);
  for (size_t i = 0; i < frames; ++i) {
    double acc = 0.0;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* s = pcm + (i * channels + c) * (size_t)n_bytes;
      double v;
      if (n_bytes == 1) {
        v = (int8_t)s[0] / 128.0;
      } else {
        int16_t x = big_endian ? (int16_t)((s[0] << 8) | s[1])
                               : (int16_t)(s[0] | (s[1] << 8));
        v = x / 32768.0;
      }
      acc += v;
    }
    out->mono[i] = (float)(acc / channels);
  }
  out->rate = rate;
  return 0;
}

int decode_any(const std::string& path, Decoded* out) {
  std::vector<uint8_t> d;
  // FLAC keeps its own buffered reader; sniff 4 bytes first.
  {
    FILE* fp = std::fopen(path.c_str(), "rb");
    if (!fp) return 1;
    uint8_t magic[4] = {0, 0, 0, 0};
    size_t got = std::fread(magic, 1, 4, fp);
    std::fclose(fp);
    if (got == 4 && !std::memcmp(magic, "fLaC", 4))
      return decode_flac_file(path, out);
  }
  int rc = read_file(path, &d);
  if (rc != 0) return rc;
  if (d.size() >= 4 && !std::memcmp(d.data(), "RIFF", 4)) return decode_wav(d, out);
  if (d.size() >= 4 && !std::memcmp(d.data(), "NIST", 4)) return decode_sphere(d, out);
  return 30;  // unrecognized container
}

// ------------------------------------------------------------- resampling

double bessel_i0(double x) {
  // Series expansion; converges fast for the beta range we use.
  double sum = 1.0, term = 1.0;
  const double hx = x / 2.0;
  for (int k = 1; k < 64; ++k) {
    term *= (hx / k) * (hx / k);
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

// Kaiser-windowed sinc interpolation at the rational ratio target/orig.
// Output sample i sits at input position i*down/up, so its fractional part
// cycles through exactly `up` phases — the tap weights are precomputed per
// phase (a polyphase filter bank), cached per (orig, target) pair.
struct PolyphaseTable {
  int up = 0, down = 0, half = 0;
  std::vector<float> taps;  // up phases x 2*half taps
};

const PolyphaseTable& get_polyphase(int orig, int target) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, PolyphaseTable> cache;
  std::lock_guard<std::mutex> lk(mu);
  auto key = std::make_pair(orig, target);
  auto it = cache.find(key);
  if (it != cache.end()) return it->second;

  PolyphaseTable tbl;
  int g = 1;
  {
    int a = orig, b = target;
    while (b) { int t = a % b; a = b; b = t; }
    g = a;
  }
  tbl.up = target / g;
  tbl.down = orig / g;
  const double cutoff = std::min(1.0, (double)target / orig);
  const int kZeros = 16;  // sinc zero crossings per side
  const double beta = 5.0;
  const double i0b = bessel_i0(beta);
  tbl.half = (int)std::ceil(kZeros / cutoff);
  tbl.taps.assign((size_t)tbl.up * 2 * tbl.half, 0.0f);
  for (int p = 0; p < tbl.up; ++p) {
    const double frac = (double)p / tbl.up;  // center = n0 + frac
    for (int k = 0; k < 2 * tbl.half; ++k) {
      const double dn = (k - tbl.half + 1) - frac;  // tap offset n - center
      const double u = dn / tbl.half;
      if (u < -1.0 || u > 1.0) continue;
      const double t = dn * cutoff;
      const double sinc =
          (std::fabs(t) < 1e-12) ? 1.0 : std::sin(M_PI * t) / (M_PI * t);
      const double win = bessel_i0(beta * std::sqrt(1.0 - u * u)) / i0b;
      tbl.taps[(size_t)p * 2 * tbl.half + k] = (float)(cutoff * sinc * win);
    }
  }
  return cache.emplace(key, std::move(tbl)).first->second;
}

void resample_sinc(const std::vector<float>& x, int orig, int target,
                   std::vector<float>* y) {
  if (orig == target || x.empty()) {
    *y = x;
    return;
  }
  const PolyphaseTable& tbl = get_polyphase(orig, target);
  const int64_t n_in = (int64_t)x.size();
  const int64_t n_out =
      (int64_t)std::ceil((double)n_in * target / orig);
  y->assign((size_t)n_out, 0.0f);
  const int width = 2 * tbl.half;
  for (int64_t i = 0; i < n_out; ++i) {
    const int64_t num = i * tbl.down;
    const int64_t n0 = num / tbl.up;
    const int phase = (int)(num % tbl.up);
    const float* w = &tbl.taps[(size_t)phase * width];
    const int64_t start = n0 - tbl.half + 1;
    int k_lo = (int)std::max<int64_t>(0, -start);
    int k_hi = (int)std::min<int64_t>(width, n_in - start);
    double acc = 0.0;
    const float* xs = x.data() + start;
    for (int k = k_lo; k < k_hi; ++k) acc += (double)w[k] * xs[k];
    (*y)[(size_t)i] = (float)acc;
  }
}

// ------------------------------------------------------------- loader core

struct Item {
  int64_t index;
  int rc;
  std::vector<float> audio;
};

struct Task {
  int64_t index;
  std::string path;
};

struct Loader {
  int64_t max_samples;
  int target_rate;
  size_t capacity;

  std::mutex mu;
  std::condition_variable cv_work;   // workers wait for tasks/slots
  std::condition_variable cv_done;   // consumer waits for next item
  std::deque<Task> tasks;
  std::map<int64_t, Item> done;      // completed, keyed by submit index
  std::deque<int64_t> order;         // indices in submission order (delivery
                                     // order); indices need not be 0,1,2,...
                                     // but must be unique while in flight
  bool closed = false;
  bool dying = false;
  int in_flight = 0;
  std::vector<std::thread> threads;

  void worker() {
    for (;;) {
      Task task;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] {
          return dying ||
                 (!tasks.empty() && done.size() + (size_t)in_flight < capacity);
        });
        if (dying) return;
        task = tasks.front();
        tasks.pop_front();
        ++in_flight;
      }
      Item item;
      item.index = task.index;
      Decoded dec;
      item.rc = decode_any(task.path, &dec);
      if (item.rc == 0) {
        std::vector<float> res;
        resample_sinc(dec.mono, dec.rate, target_rate, &res);
        if ((int64_t)res.size() > max_samples) res.resize((size_t)max_samples);
        item.audio = std::move(res);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        done.emplace(item.index, std::move(item));
        --in_flight;
      }
      cv_done.notify_all();
      cv_work.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* rst_loader_create(int n_threads, int64_t max_samples, int target_rate,
                        int capacity) {
  auto* ld = new Loader();
  ld->max_samples = max_samples;
  ld->target_rate = target_rate;
  ld->capacity = (size_t)std::max(1, capacity);
  n_threads = std::max(1, n_threads);
  for (int i = 0; i < n_threads; ++i)
    ld->threads.emplace_back(&Loader::worker, ld);
  return ld;
}

// Submission order defines delivery order; indices may be arbitrary but
// must be unique among items not yet delivered. Returns 0.
int rst_loader_submit(void* handle, int64_t index, const char* path) {
  auto* ld = (Loader*)handle;
  {
    std::lock_guard<std::mutex> lk(ld->mu);
    ld->tasks.push_back(Task{index, std::string(path)});
    ld->order.push_back(index);
  }
  ld->cv_work.notify_one();
  return 0;
}

void rst_loader_close(void* handle) {
  auto* ld = (Loader*)handle;
  std::lock_guard<std::mutex> lk(ld->mu);
  ld->closed = true;
  ld->cv_done.notify_all();
}

// Blocks for the next item in submission order.  Returns the item's decode
// rc (0 = ok), or -1 when the stream is exhausted.  Audio is copied into
// out (cap floats); *n receives the sample count.
int rst_loader_next(void* handle, int64_t* index, float* out, int64_t cap,
                    int64_t* n) {
  auto* ld = (Loader*)handle;
  Item item;
  {
    std::unique_lock<std::mutex> lk(ld->mu);
    for (;;) {
      if (!ld->order.empty()) {
        auto it = ld->done.find(ld->order.front());
        if (it != ld->done.end()) {
          item = std::move(it->second);
          ld->done.erase(it);
          ld->order.pop_front();
          break;
        }
      }
      // The stream is exhausted when closed and every submitted index has
      // been delivered — keyed off the order queue, so arbitrary (non-
      // consecutive) submit indices drain correctly instead of hanging.
      if (ld->closed && ld->order.empty()) return -1;
      ld->cv_done.wait(lk);
    }
  }
  ld->cv_work.notify_all();  // a capacity slot opened up
  *index = item.index;
  int64_t count = std::min<int64_t>((int64_t)item.audio.size(), cap);
  if (count > 0) std::memcpy(out, item.audio.data(), (size_t)count * 4);
  *n = count;
  return item.rc;
}

void rst_loader_destroy(void* handle) {
  auto* ld = (Loader*)handle;
  {
    std::lock_guard<std::mutex> lk(ld->mu);
    ld->dying = true;
  }
  ld->cv_work.notify_all();
  for (auto& t : ld->threads) t.join();
  delete ld;
}

}  // extern "C"
