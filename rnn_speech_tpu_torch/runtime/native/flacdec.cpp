// flacdec.cpp — native FLAC stream decoder for the rnn_speech_tpu_torch host
// runtime (a copy of the JAX package's runtime/native/flacdec.cpp, same C ABI).
//
// FLAC (LibriSpeech's container) is decoded here in C++ and handed to the
// input pipeline as raw PCM.  Decode-only, full subset coverage:
// CONSTANT / VERBATIM / FIXED / LPC subframes, 4-bit and 5-bit Rice
// residuals with escape codes, all stereo decorrelation modes, wasted bits.
//
// Exposed as a C ABI consumed via ctypes (runtime/audiodec.py); built at
// first use by runtime/native_build.py.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  bool eof() const { return byte_pos_ >= size_ && nbits_ == 0; }
  size_t byte_position() const { return byte_pos_ - nbits_ / 8; }

  // Read up to 32 bits, MSB first. Returns false on end of stream.
  bool read_bits(int n, uint32_t* out) {
    while (nbits_ < n) {
      if (byte_pos_ >= size_) return false;
      buf_ = (buf_ << 8) | data_[byte_pos_++];
      nbits_ += 8;
    }
    *out = (uint32_t)((buf_ >> (nbits_ - n)) & ((n == 32) ? 0xFFFFFFFFull
                                                          : ((1ull << n) - 1)));
    nbits_ -= n;
    return true;
  }

  bool read_signed(int n, int32_t* out) {
    uint32_t v;
    if (!read_bits(n, &v)) return false;
    // Sign-extend n-bit two's complement.
    if (n > 0 && (v >> (n - 1))) v |= ~((n == 32) ? 0xFFFFFFFFu : ((1u << n) - 1));
    *out = (int32_t)v;
    return true;
  }

  // Read up to 57 bits, MSB first — sample reads can need 33 bits (32-bps
  // stream + the side channel's extra bit), beyond read_bits' 32-bit out.
  bool read_bits64(int n, uint64_t* out) {
    while (nbits_ < n) {
      if (byte_pos_ >= size_) return false;
      buf_ = (buf_ << 8) | data_[byte_pos_++];
      nbits_ += 8;
    }
    *out = (buf_ >> (nbits_ - n)) & ((n >= 64) ? ~0ull : ((1ull << n) - 1));
    nbits_ -= n;
    return true;
  }

  bool read_signed64(int n, int64_t* out) {
    uint64_t v;
    if (!read_bits64(n, &v)) return false;
    if (n > 0 && n < 64 && (v >> (n - 1))) v |= ~((1ull << n) - 1);
    *out = (int64_t)v;
    return true;
  }

  // Count zero bits until a 1 bit (unary code).
  bool read_unary(uint32_t* out) {
    uint32_t count = 0;
    for (;;) {
      while (nbits_ == 0) {
        if (byte_pos_ >= size_) return false;
        buf_ = (buf_ << 8) | data_[byte_pos_++];
        nbits_ += 8;
      }
      // Scan buffered bits for the terminating 1.
      while (nbits_ > 0) {
        uint64_t bit = (buf_ >> (nbits_ - 1)) & 1;
        nbits_--;
        if (bit) {
          *out = count;
          return true;
        }
        count++;
      }
    }
  }

  void align_to_byte() { nbits_ -= nbits_ % 8; }

  bool skip_bytes(size_t n) {
    align_to_byte();
    size_t buffered = nbits_ / 8;
    while (n > 0 && buffered > 0) {
      nbits_ -= 8;
      buffered--;
      n--;
    }
    if (byte_pos_ + n > size_) return false;
    byte_pos_ += n;
    return true;
  }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t byte_pos_ = 0;
  uint64_t buf_ = 0;
  int nbits_ = 0;
};

struct StreamInfo {
  uint32_t sample_rate = 0;
  uint32_t channels = 0;
  uint32_t bits_per_sample = 0;
  uint64_t total_samples = 0;
};

bool decode_residual(BitReader& br, int order, int blocksize,
                     std::vector<int64_t>& out) {
  uint32_t method, partition_order;
  if (!br.read_bits(2, &method)) return false;
  if (method > 1) return false;
  if (!br.read_bits(4, &partition_order)) return false;
  const int param_bits = method == 0 ? 4 : 5;
  const uint32_t escape = method == 0 ? 0xF : 0x1F;
  const int partitions = 1 << partition_order;
  if (blocksize % partitions != 0) return false;
  int idx = order;
  for (int p = 0; p < partitions; ++p) {
    int count = blocksize >> partition_order;
    if (p == 0) count -= order;
    if (count < 0) return false;
    uint32_t param;
    if (!br.read_bits(param_bits, &param)) return false;
    if (param == escape) {
      uint32_t raw_bits;
      if (!br.read_bits(5, &raw_bits)) return false;
      for (int i = 0; i < count; ++i) {
        int32_t v = 0;
        if (raw_bits > 0) {
          if (!br.read_signed((int)raw_bits, &v)) return false;
        }
        out[idx++] = v;
      }
    } else {
      for (int i = 0; i < count; ++i) {
        uint32_t q, r = 0;
        if (!br.read_unary(&q)) return false;
        if (param > 0 && !br.read_bits((int)param, &r)) return false;
        uint64_t u = ((uint64_t)q << param) | r;
        out[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
      }
    }
  }
  return true;
}

bool decode_subframe(BitReader& br, int blocksize, int bps,
                     std::vector<int64_t>& samples) {
  uint32_t pad, type_code, wasted_flag;
  if (!br.read_bits(1, &pad) || pad != 0) return false;
  if (!br.read_bits(6, &type_code)) return false;
  if (!br.read_bits(1, &wasted_flag)) return false;
  uint32_t wasted = 0;
  if (wasted_flag) {
    uint32_t u;
    if (!br.read_unary(&u)) return false;
    wasted = u + 1;
    bps -= (int)wasted;
    if (bps <= 0) return false;
  }

  samples.assign(blocksize, 0);
  if (type_code == 0) {  // CONSTANT
    int64_t v;
    if (!br.read_signed64(bps, &v)) return false;
    for (int i = 0; i < blocksize; ++i) samples[i] = v;
  } else if (type_code == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; ++i) {
      int64_t v;
      if (!br.read_signed64(bps, &v)) return false;
      samples[i] = v;
    }
  } else if (type_code >= 8 && type_code <= 12) {  // FIXED, order 0-4
    const int order = (int)type_code - 8;
    for (int i = 0; i < order; ++i) {
      int64_t v;
      if (!br.read_signed64(bps, &v)) return false;
      samples[i] = v;
    }
    if (!decode_residual(br, order, blocksize, samples)) return false;
    switch (order) {
      case 0:
        break;
      case 1:
        for (int i = 1; i < blocksize; ++i) samples[i] += samples[i - 1];
        break;
      case 2:
        for (int i = 2; i < blocksize; ++i)
          samples[i] += 2 * samples[i - 1] - samples[i - 2];
        break;
      case 3:
        for (int i = 3; i < blocksize; ++i)
          samples[i] += 3 * samples[i - 1] - 3 * samples[i - 2] + samples[i - 3];
        break;
      case 4:
        for (int i = 4; i < blocksize; ++i)
          samples[i] += 4 * samples[i - 1] - 6 * samples[i - 2] +
                        4 * samples[i - 3] - samples[i - 4];
        break;
      default:
        return false;
    }
  } else if (type_code >= 32) {  // LPC, order 1-32
    const int order = (int)(type_code & 31) + 1;
    for (int i = 0; i < order; ++i) {
      int64_t v;
      if (!br.read_signed64(bps, &v)) return false;
      samples[i] = v;
    }
    uint32_t precision_m1;
    if (!br.read_bits(4, &precision_m1)) return false;
    if (precision_m1 == 15) return false;
    const int precision = (int)precision_m1 + 1;
    int32_t shift;
    if (!br.read_signed(5, &shift)) return false;
    if (shift < 0) shift = 0;
    int32_t coefs[32];
    for (int i = 0; i < order; ++i) {
      if (!br.read_signed(precision, &coefs[i])) return false;
    }
    if (!decode_residual(br, order, blocksize, samples)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += (int64_t)coefs[j] * samples[i - 1 - j];
      samples[i] += acc >> shift;
    }
  } else {
    return false;  // reserved subframe type
  }

  if (wasted) {
    for (int i = 0; i < blocksize; ++i) samples[i] <<= wasted;
  }
  return true;
}

// Decode the UTF-8-style coded frame/sample number (consumed, value unused).
bool skip_coded_number(BitReader& br) {
  uint32_t first;
  if (!br.read_bits(8, &first)) return false;
  int extra = 0;
  for (uint32_t mask = 0x80; first & mask; mask >>= 1) extra++;
  if (extra == 1 || extra > 7) return false;
  if (extra > 0) extra -= 1;
  for (int i = 0; i < extra; ++i) {
    uint32_t b;
    if (!br.read_bits(8, &b)) return false;
    if ((b & 0xC0) != 0x80) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Decode a FLAC file into interleaved int32 samples (native bit depth kept;
// bits-per-sample reported through *out_bps).  Returns 0 on success.
int rst_flac_decode(const char* path, int32_t** out_samples, int64_t* out_count,
                    int32_t* out_channels, int32_t* out_rate, int32_t* out_bps) {
  *out_samples = nullptr;
  *out_count = 0;

  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  std::fseek(fp, 0, SEEK_END);
  long fsize = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  std::vector<uint8_t> data((size_t)fsize);
  if (fsize > 0 && std::fread(data.data(), 1, (size_t)fsize, fp) != (size_t)fsize) {
    std::fclose(fp);
    return 2;
  }
  std::fclose(fp);

  BitReader br(data.data(), data.size());
  uint32_t magic;
  if (!br.read_bits(32, &magic) || magic != 0x664C6143u /* "fLaC" */) return 3;

  StreamInfo info;
  bool last = false;
  while (!last) {
    uint32_t head, len;
    if (!br.read_bits(8, &head) || !br.read_bits(24, &len)) return 4;
    last = (head & 0x80) != 0;
    const uint32_t block_type = head & 0x7F;
    if (block_type == 0) {  // STREAMINFO
      if (len < 34) return 5;
      uint32_t tmp;
      br.read_bits(16, &tmp);  // min blocksize
      br.read_bits(16, &tmp);  // max blocksize
      br.read_bits(24, &tmp);  // min framesize
      br.read_bits(24, &tmp);  // max framesize
      br.read_bits(20, &info.sample_rate);
      br.read_bits(3, &tmp);
      info.channels = tmp + 1;
      br.read_bits(5, &tmp);
      info.bits_per_sample = tmp + 1;
      uint32_t hi, lo;
      br.read_bits(4, &hi);
      br.read_bits(32, &lo);
      info.total_samples = ((uint64_t)hi << 32) | lo;
      if (!br.skip_bytes(16)) return 6;  // MD5
      if (len > 34 && !br.skip_bytes(len - 34)) return 6;
    } else {
      if (!br.skip_bytes(len)) return 6;
    }
  }
  if (info.sample_rate == 0 || info.channels == 0 || info.channels > 8) return 7;

  const uint32_t channels = info.channels;
  std::vector<int32_t> pcm;
  if (info.total_samples > 0) pcm.reserve((size_t)(info.total_samples * channels));
  std::vector<int64_t> ch_buf[8];

  // Frame loop.
  for (;;) {
    br.align_to_byte();
    uint32_t sync;
    if (!br.read_bits(14, &sync)) break;  // normal EOF
    if (sync != 0x3FFE) return 8;
    uint32_t reserved, strategy;
    if (!br.read_bits(1, &reserved) || !br.read_bits(1, &strategy)) return 8;
    uint32_t bs_code, sr_code, ch_code, ss_code, pad;
    if (!br.read_bits(4, &bs_code) || !br.read_bits(4, &sr_code) ||
        !br.read_bits(4, &ch_code) || !br.read_bits(3, &ss_code) ||
        !br.read_bits(1, &pad))
      return 8;
    if (!skip_coded_number(br)) return 8;

    int blocksize;
    switch (bs_code) {
      case 1: blocksize = 192; break;
      case 2: case 3: case 4: case 5: blocksize = 576 << (bs_code - 2); break;
      case 6: {
        uint32_t v;
        if (!br.read_bits(8, &v)) return 8;
        blocksize = (int)v + 1;
        break;
      }
      case 7: {
        uint32_t v;
        if (!br.read_bits(16, &v)) return 8;
        blocksize = (int)v + 1;
        break;
      }
      default:
        if (bs_code >= 8) blocksize = 256 << (bs_code - 8);
        else return 8;  // code 0 reserved
    }
    // Sample rate field: value comes from STREAMINFO, but variable-size
    // encodings still occupy bits that must be consumed.
    if (sr_code == 12) { uint32_t v; if (!br.read_bits(8, &v)) return 8; }
    else if (sr_code == 13 || sr_code == 14) { uint32_t v; if (!br.read_bits(16, &v)) return 8; }

    int bps;
    switch (ss_code) {
      case 0: bps = (int)info.bits_per_sample; break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return 8;
    }
    uint32_t crc8;
    if (!br.read_bits(8, &crc8)) return 8;

    uint32_t frame_channels = (ch_code < 8) ? ch_code + 1 : 2;
    if (frame_channels != channels) return 9;

    for (uint32_t c = 0; c < frame_channels; ++c) {
      int ch_bps = bps;
      // Side channels carry one extra bit.
      if ((ch_code == 8 && c == 1) || (ch_code == 9 && c == 0) ||
          (ch_code == 10 && c == 1))
        ch_bps += 1;
      if (!decode_subframe(br, blocksize, ch_bps, ch_buf[c])) return 10;
    }
    br.align_to_byte();
    uint32_t crc16a, crc16b;
    if (!br.read_bits(8, &crc16a) || !br.read_bits(8, &crc16b)) return 8;

    // Undo inter-channel decorrelation.
    if (ch_code == 8) {  // left/side
      for (int i = 0; i < blocksize; ++i) ch_buf[1][i] = ch_buf[0][i] - ch_buf[1][i];
    } else if (ch_code == 9) {  // right/side: ch0=side, ch1=right
      for (int i = 0; i < blocksize; ++i) ch_buf[0][i] = ch_buf[0][i] + ch_buf[1][i];
    } else if (ch_code == 10) {  // mid/side
      for (int i = 0; i < blocksize; ++i) {
        int64_t side = ch_buf[1][i];
        int64_t mid = (ch_buf[0][i] << 1) | (side & 1);
        ch_buf[0][i] = (mid + side) >> 1;
        ch_buf[1][i] = (mid - side) >> 1;
      }
    }

    for (int i = 0; i < blocksize; ++i) {
      for (uint32_t c = 0; c < channels; ++c) {
        pcm.push_back((int32_t)ch_buf[c][i]);
      }
    }
    if (info.total_samples > 0 &&
        pcm.size() >= info.total_samples * channels)
      break;
  }

  // Trim a final partial frame's padding if STREAMINFO promised fewer samples.
  if (info.total_samples > 0 && pcm.size() > info.total_samples * channels) {
    pcm.resize((size_t)(info.total_samples * channels));
  }

  int32_t* out = (int32_t*)std::malloc(pcm.size() * sizeof(int32_t));
  if (!out) return 11;
  std::memcpy(out, pcm.data(), pcm.size() * sizeof(int32_t));
  *out_samples = out;
  *out_count = (int64_t)(pcm.size() / channels);
  *out_channels = (int32_t)channels;
  *out_rate = (int32_t)info.sample_rate;
  *out_bps = (int32_t)info.bits_per_sample;
  return 0;
}

void rst_free(void* p) { std::free(p); }

}  // extern "C"
