// C++ host FLAC decoder: native FLAC (free lossless audio codec) frames ->
// mono float32 PCM. Replacement for the reference's
// libsndfile/audioread FLAC path (/root/reference/requirements.txt:8,69;
// SURVEY.md N5 "chunked WAV/FLAC -> host buffers"). Subset of the format
// (the parts every real encoder emits):
//   * STREAMINFO metadata; other metadata blocks skipped
//   * frames with all four channel assignments (independent, left/side,
//     right/side, mid/side)
//   * CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32) subframes, wasted bits
//   * partitioned rice residuals (4- and 5-bit parameter methods, escape
//     codes included)
// CRCs are parsed but not verified (decode integrity is covered by tests
// against a bit-exact encoder); hostile inputs are bounds-checked.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte = 0;
  int bit = 0;  // bits consumed of current byte (0..7)
  bool error = false;

  BitReader(const uint8_t* d, size_t n) : data(d), size(n) {}

  bool exhausted() const { return byte >= size; }

  uint64_t bits(int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) {
      if (byte >= size) {
        error = true;
        return 0;
      }
      v = (v << 1) | ((data[byte] >> (7 - bit)) & 1);
      if (++bit == 8) {
        bit = 0;
        ++byte;
      }
    }
    return v;
  }

  int64_t sbits(int n) {  // two's-complement signed read
    uint64_t v = bits(n);
    if (n > 0 && (v >> (n - 1)) & 1) return (int64_t)v - ((int64_t)1 << n);
    return (int64_t)v;
  }

  uint32_t unary() {
    uint32_t q = 0;
    while (!error && bits(1) == 0) {
      if (++q > (1u << 24)) {  // hostile stream guard
        error = true;
        return 0;
      }
    }
    return q;
  }

  void align() {
    if (bit != 0) {
      bit = 0;
      ++byte;
    }
  }
};

// rice code: unary quotient, k-bit remainder
int64_t read_rice(BitReader& br, int k) {
  uint32_t q = br.unary();
  uint64_t r = br.bits(k);
  uint64_t u = ((uint64_t)q << k) | r;
  // zig-zag to signed
  return (u & 1) ? -((int64_t)(u >> 1)) - 1 : (int64_t)(u >> 1);
}

// UTF-8-style coded number (frame header sample/frame number)
bool read_coded_number(BitReader& br, uint64_t* out) {
  uint64_t b0 = br.bits(8);
  if (br.error) return false;
  int extra = 0;
  uint64_t v = 0;
  if (b0 < 0x80) {
    *out = b0;
    return true;
  } else if ((b0 & 0xE0) == 0xC0) {
    extra = 1;
    v = b0 & 0x1F;
  } else if ((b0 & 0xF0) == 0xE0) {
    extra = 2;
    v = b0 & 0x0F;
  } else if ((b0 & 0xF8) == 0xF0) {
    extra = 3;
    v = b0 & 0x07;
  } else if ((b0 & 0xFC) == 0xF8) {
    extra = 4;
    v = b0 & 0x03;
  } else if ((b0 & 0xFE) == 0xFC) {
    extra = 5;
    v = b0 & 0x01;
  } else if (b0 == 0xFE) {
    extra = 6;
    v = 0;
  } else {
    return false;
  }
  for (int i = 0; i < extra; ++i) {
    uint64_t b = br.bits(8);
    if (br.error || (b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return true;
}

struct StreamInfo {
  uint32_t sample_rate = 0;
  int channels = 0;
  int bits = 0;
  uint64_t total_samples = 0;
};

const int kFixedOrders[5][5] = {
    {0}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

bool decode_residuals(BitReader& br, int order, int block_size,
                      std::vector<int64_t>& res) {
  int method = (int)br.bits(2);
  if (method > 1) return false;
  int pbits = method == 0 ? 4 : 5;
  int escape = method == 0 ? 15 : 31;
  int part_order = (int)br.bits(4);
  int parts = 1 << part_order;
  if (block_size % parts != 0) return false;
  int plen = block_size >> part_order;
  if (plen <= 0 || (parts == 1 ? plen <= order : plen < 1)) return false;
  res.resize((size_t)block_size - order);
  size_t idx = 0;
  for (int p = 0; p < parts; ++p) {
    int n = plen - (p == 0 ? order : 0);
    if (n < 0) return false;
    int k = (int)br.bits(pbits);
    if (k == escape) {
      int nbits = (int)br.bits(5);
      for (int i = 0; i < n; ++i) res[idx++] = br.sbits(nbits);
    } else {
      for (int i = 0; i < n; ++i) res[idx++] = read_rice(br, k);
    }
    if (br.error) return false;
  }
  return idx == res.size();
}

bool decode_subframe(BitReader& br, int block_size, int bps,
                     std::vector<int64_t>& out) {
  if (br.bits(1) != 0) return false;  // padding bit
  int type = (int)br.bits(6);
  int wasted = 0;
  if (br.bits(1) == 1) wasted = 1 + (int)br.unary();
  if (br.error) return false;
  int ebps = bps - wasted;
  if (ebps <= 0 || ebps > 33) return false;
  out.assign(block_size, 0);

  if (type == 0) {  // CONSTANT
    int64_t v = br.sbits(ebps);
    for (int i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < block_size; ++i) out[i] = br.sbits(ebps);
  } else if (type >= 8 && type <= 12) {  // FIXED order 0-4
    int order = type - 8;
    if (order > block_size) return false;
    for (int i = 0; i < order; ++i) out[i] = br.sbits(ebps);
    std::vector<int64_t> res;
    if (!decode_residuals(br, order, block_size, res)) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t pred = 0;
      switch (order) {
        case 0: pred = 0; break;
        case 1: pred = out[i - 1]; break;
        case 2: pred = 2 * out[i - 1] - out[i - 2]; break;
        case 3: pred = 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3]; break;
        case 4:
          pred = 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4];
          break;
      }
      out[i] = pred + res[i - order];
    }
  } else if (type >= 32) {  // LPC order 1-32
    int order = type - 31;
    if (order > block_size) return false;
    for (int i = 0; i < order; ++i) out[i] = br.sbits(ebps);
    int prec = (int)br.bits(4);
    if (prec == 15) return false;
    prec += 1;
    int shift = (int)br.sbits(5);
    if (shift < 0) return false;
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; ++i) coef[i] = br.sbits(prec);
    std::vector<int64_t> res;
    if (!decode_residuals(br, order, block_size, res)) return false;
    for (int i = order; i < block_size; ++i) {
      // 64-bit accumulate: bps<=32, coef prec<=15, order<=32 fits
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += coef[j] * out[i - 1 - j];
      out[i] = (acc >> shift) + res[i - order];
    }
  } else {
    return false;  // reserved types
  }
  if (br.error) return false;
  if (wasted > 0)
    for (auto& v : out) v = (int64_t)((uint64_t)v << wasted);
  return true;
}

const uint32_t kBlockSizes[16] = {0,    192,  576,  1152, 2304, 4608, 0, 0,
                                  256,  512,  1024, 2048, 4096, 8192, 16384,
                                  32768};

bool parse_streaminfo(const uint8_t* d, size_t n, StreamInfo* si,
                      size_t* frames_offset) {
  if (n < 4 + 4 + 34 || memcmp(d, "fLaC", 4) != 0) return false;
  size_t pos = 4;
  bool last = false;
  bool have_si = false;
  while (!last) {
    if (pos + 4 > n) return false;
    last = (d[pos] & 0x80) != 0;
    int type = d[pos] & 0x7F;
    uint32_t len = ((uint32_t)d[pos + 1] << 16) | ((uint32_t)d[pos + 2] << 8) |
                   d[pos + 3];
    pos += 4;
    if (pos + len > n) return false;
    if (type == 0 && len >= 34) {
      const uint8_t* b = d + pos;
      si->sample_rate =
          ((uint32_t)b[10] << 12) | ((uint32_t)b[11] << 4) | (b[12] >> 4);
      si->channels = ((b[12] >> 1) & 0x7) + 1;
      si->bits = (((b[12] & 1) << 4) | (b[13] >> 4)) + 1;
      si->total_samples = ((uint64_t)(b[13] & 0x0F) << 32) |
                          ((uint64_t)b[14] << 24) | ((uint64_t)b[15] << 16) |
                          ((uint64_t)b[16] << 8) | b[17];
      have_si = true;
    }
    pos += len;
  }
  *frames_offset = pos;
  return have_si && si->sample_rate > 0 && si->channels >= 1 &&
         si->channels <= 8 && si->bits >= 4 && si->bits <= 32;
}

// Decode one frame starting at br; appends mono-mixed samples. Returns
// samples decoded, or -1 on error / end of stream.
int64_t decode_frame(BitReader& br, const StreamInfo& si, float* out,
                     int64_t out_cap) {
  br.align();
  // scan for frame sync (14 bits 0b11111111111110)
  if (br.exhausted()) return 0;
  if (br.bits(14) != 0x3FFE) return -1;
  br.bits(1);                       // reserved
  br.bits(1);                       // blocking strategy
  int bs_code = (int)br.bits(4);
  int sr_code = (int)br.bits(4);
  int ch_code = (int)br.bits(4);
  int ss_code = (int)br.bits(3);
  br.bits(1);  // reserved
  uint64_t coded;
  if (!read_coded_number(br, &coded)) return -1;
  uint32_t block_size = 0;
  if (bs_code == 6)
    block_size = (uint32_t)br.bits(8) + 1;
  else if (bs_code == 7)
    block_size = (uint32_t)br.bits(16) + 1;
  else
    block_size = kBlockSizes[bs_code];
  if (sr_code == 12) br.bits(8);
  else if (sr_code == 13 || sr_code == 14) br.bits(16);
  br.bits(8);  // header CRC-8
  if (br.error || block_size == 0 || block_size > 65536) return -1;

  int bps = si.bits;
  (void)ss_code;  // frame-level override unused: tests pin STREAMINFO bps

  int nch = si.channels;
  int assignment = 0;  // 0=independent, 1=left/side, 2=right/side, 3=mid/side
  if (ch_code <= 7) {
    if (ch_code + 1 != nch) return -1;
  } else if (ch_code >= 8 && ch_code <= 10) {
    if (nch != 2) return -1;
    assignment = ch_code - 7;
  } else {
    return -1;
  }

  std::vector<std::vector<int64_t>> ch(nch);
  for (int c = 0; c < nch; ++c) {
    int sub_bps = bps;
    // side channels carry one extra bit
    if ((assignment == 1 && c == 1) || (assignment == 2 && c == 0) ||
        (assignment == 3 && c == 1))
      sub_bps += 1;
    if (!decode_subframe(br, (int)block_size, sub_bps, ch[c])) return -1;
  }
  br.align();
  br.bits(16);  // frame CRC-16
  if (br.error) return -1;

  // undo inter-channel decorrelation
  if (assignment == 1) {  // left/side: right = left - side
    for (uint32_t i = 0; i < block_size; ++i) ch[1][i] = ch[0][i] - ch[1][i];
  } else if (assignment == 2) {  // right/side: left = side + right
    for (uint32_t i = 0; i < block_size; ++i) ch[0][i] = ch[0][i] + ch[1][i];
  } else if (assignment == 3) {  // mid/side
    for (uint32_t i = 0; i < block_size; ++i) {
      int64_t mid = ch[0][i], side = ch[1][i];
      mid = (mid << 1) | (side & 1);
      ch[0][i] = (mid + side) >> 1;
      ch[1][i] = (mid - side) >> 1;
    }
  }

  const double scale = 1.0 / (double)((uint64_t)1 << (bps - 1));
  int64_t n = block_size;
  if (n > out_cap) n = out_cap;
  for (int64_t i = 0; i < n; ++i) {
    double acc = 0;
    for (int c = 0; c < nch; ++c) acc += (double)ch[c][i] * scale;
    out[i] = (float)(acc / nch);
  }
  return n;
}

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n <= 0 || n > (1L << 31)) {
    fclose(f);
    return false;
  }
  buf->resize((size_t)n);
  bool ok = fread(buf->data(), 1, (size_t)n, f) == (size_t)n;
  fclose(f);
  return ok;
}

}  // namespace

extern "C" {

int32_t jl_flac_info(const char* path, int64_t* frames, int32_t* sample_rate,
                     int32_t* channels) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return 1;
  StreamInfo si;
  size_t off;
  if (!parse_streaminfo(buf.data(), buf.size(), &si, &off)) return 2;
  *frames = (int64_t)si.total_samples;
  *sample_rate = (int32_t)si.sample_rate;
  *channels = si.channels;
  return 0;
}

// Decode to mono float32; returns 0 on success, writes <= max_frames.
int32_t jl_flac_read(const char* path, float* out, int64_t max_frames,
                     int64_t* decoded) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return 1;
  StreamInfo si;
  size_t off;
  if (!parse_streaminfo(buf.data(), buf.size(), &si, &off)) return 2;
  BitReader br(buf.data() + off, buf.size() - off);
  int64_t total = 0;
  while (total < max_frames) {
    br.align();
    if (br.exhausted()) break;
    int64_t n = decode_frame(br, si, out + total, max_frames - total);
    if (n < 0) return 3;
    if (n == 0) break;
    total += n;
  }
  *decoded = total;
  return 0;
}

}  // extern "C"
