// C++ host WAV decoder: chunked RIFF/WAVE parsing -> mono float32 PCM.
// Replacement for the reference's libsndfile/audioread decode
// (/root/reference/requirements.txt:8,69; SURVEY.md N5). Supports PCM
// 8/16/24/32-bit and IEEE float32/float64, multi-channel mixdown. Bound via
// ctypes; the Python stdlib `wave` path is the fallback.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct WavInfo {
  int32_t sample_rate = 0;
  int32_t channels = 0;
  int32_t bits = 0;
  int32_t format = 0;  // 1 = PCM, 3 = IEEE float
  long data_offset = 0;
  int64_t data_bytes = 0;
};

bool parse_header(FILE* f, WavInfo* info) {
  char id[4];
  uint32_t sz;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "RIFF", 4) != 0) return false;
  if (fread(&sz, 4, 1, f) != 1) return false;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "WAVE", 4) != 0) return false;
  bool have_fmt = false;
  while (fread(id, 1, 4, f) == 4 && fread(&sz, 4, 1, f) == 1) {
    if (memcmp(id, "fmt ", 4) == 0) {
      // the chunk size is untrusted: reject anything shorter than the
      // 16-byte base fmt block (or 40 for extensible) before the fixed-
      // offset reads below, and cap it so hostile sizes can't OOM us
      if (sz < 16 || sz > 1u << 20) return false;
      std::vector<uint8_t> buf(sz);
      if (fread(buf.data(), 1, sz, f) != sz) return false;
      uint16_t fmt, ch, bits;
      uint32_t rate;
      memcpy(&fmt, buf.data(), 2);
      memcpy(&ch, buf.data() + 2, 2);
      memcpy(&rate, buf.data() + 4, 4);
      memcpy(&bits, buf.data() + 14, 2);
      if (fmt == 0xFFFE) {  // WAVE_FORMAT_EXTENSIBLE
        if (sz < 40) return false;
        uint16_t sub;
        memcpy(&sub, buf.data() + 24, 2);
        fmt = sub;
      }
      // bits in 1..7 would pass a !=0 check but make bytes-per-frame zero
      if (bits < 8 || bits % 8 != 0 || bits > 64 || ch == 0) return false;
      info->format = fmt;
      info->channels = ch;
      info->sample_rate = static_cast<int32_t>(rate);
      info->bits = bits;
      have_fmt = true;
    } else if (memcmp(id, "data", 4) == 0) {
      info->data_offset = ftell(f);
      info->data_bytes = sz;
      return have_fmt;
    } else {
      if (fseek(f, (sz + 1) & ~1u, SEEK_CUR) != 0) return false;
    }
  }
  return false;
}

}  // namespace

extern "C" {

// Fill (frames, sample_rate, channels); returns 0 on success.
int32_t jl_wav_info(const char* path, int64_t* frames, int32_t* sample_rate,
                    int32_t* channels) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  WavInfo info;
  const bool ok = parse_header(f, &info);
  fclose(f);
  if (!ok || info.bits == 0 || info.channels == 0) return 2;
  *frames = info.data_bytes / (info.channels * (info.bits / 8));
  *sample_rate = info.sample_rate;
  *channels = info.channels;
  return 0;
}

// Decode to mono float32 (channel average), writing up to max_frames.
int32_t jl_wav_read(const char* path, float* out, int64_t max_frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  WavInfo info;
  if (!parse_header(f, &info)) {
    fclose(f);
    return 2;
  }
  const int bytes_per = info.bits / 8;
  const int64_t frames =
      std::min<int64_t>(max_frames, info.data_bytes / (info.channels * bytes_per));
  fseek(f, info.data_offset, SEEK_SET);

  const int64_t CHUNK = 65536;  // frames per read
  std::vector<uint8_t> buf(CHUNK * info.channels * bytes_per);
  int64_t done = 0;
  while (done < frames) {
    const int64_t want = std::min(CHUNK, frames - done);
    const size_t got =
        fread(buf.data(), info.channels * bytes_per, want, f);
    if (got == 0) break;
    for (size_t i = 0; i < got; ++i) {
      double acc = 0.0;
      for (int c = 0; c < info.channels; ++c) {
        const uint8_t* p = buf.data() + (i * info.channels + c) * bytes_per;
        double v = 0.0;
        if (info.format == 3 && info.bits == 32) {
          float fv;
          memcpy(&fv, p, 4);
          v = fv;
        } else if (info.format == 3 && info.bits == 64) {
          double dv;
          memcpy(&dv, p, 8);
          v = dv;
        } else if (info.bits == 16) {
          int16_t s;
          memcpy(&s, p, 2);
          v = s / 32768.0;
        } else if (info.bits == 32) {
          int32_t s;
          memcpy(&s, p, 4);
          v = s / 2147483648.0;
        } else if (info.bits == 24) {
          int32_t s = p[0] | (p[1] << 8) | (p[2] << 16);
          if (s & 0x800000) s -= 0x1000000;
          v = s / 8388608.0;
        } else if (info.bits == 8) {
          v = (static_cast<int>(p[0]) - 128) / 128.0;
        }
        acc += v;
      }
      out[done + i] = static_cast<float>(acc / info.channels);
    }
    done += got;
  }
  fclose(f);
  return done == frames ? 0 : 3;
}

}  // extern "C"
