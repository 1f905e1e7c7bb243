// Native audio I/O for the host decode path.
//
// The reference decodes per-track through librosa -> audioread/soxr (Python
// + ffmpeg subprocess per file; reference scripts/06:69, 10:149, 18:88).
// Here the host-side staging runs through this small C++ library:
//   - RIFF/WAVE parsing (PCM16/24/32, float32/64), multi-channel -> mono
//   - polyphase windowed-sinc resampling to the target rate (librosa loads
//     at sr=22050; quality comparable to soxr's default band-limited sinc)
//   - direct staging into a caller-provided float32 buffer (zero-copy into
//     the pinned host buffer that feeds device DMA)
// Built as a shared library, bound via ctypes (vae_hmc_tpu_torch/io/native:
// the port's copy of vae_hmc_tpu/io/native/audioio.cpp, whose code it
// repeats line for line; only comments differ).
//
// Exposed C ABI:
//   int audioio_load_wav(const char* path, int target_sr, float* out,
//                        long out_capacity, long* out_len);
//     returns 0 on success, negative error codes otherwise.
//   int audioio_resample(const float* in, long in_len, int in_sr,
//                        int out_sr, float* out, long out_capacity,
//                        long* out_len);
//   int audioio_load_mp3(const char* path, int target_sr,
//                        double max_seconds, float* out, long out_capacity,
//                        long* out_len);
//     In-process MPEG Layer I/II/III decode through libmpg123 (dlopen'd at
//     first use — no per-file subprocess; the FMA corpus is ~3k mp3s and
//     the reference's librosa->audioread path spawns a decoder process per
//     track).  Decodes at the stream's native rate/channels as float32,
//     downmixes by channel mean (librosa to_mono), then feeds the same
//     windowed-sinc resampler as the wav path.

#include <dlfcn.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

struct WavInfo {
  int sample_rate = 0;
  int channels = 0;
  int bits = 0;
  int format = 0;  // 1 = PCM, 3 = IEEE float
  long data_offset = 0;
  long data_bytes = 0;
};

int parse_wav_header(FILE* f, WavInfo* info) {
  char id[4];
  uint32_t sz;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "RIFF", 4) != 0) return -2;
  if (fread(&sz, 4, 1, f) != 1) return -2;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "WAVE", 4) != 0) return -2;
  while (fread(id, 1, 4, f) == 4 && fread(&sz, 4, 1, f) == 1) {
    if (memcmp(id, "fmt ", 4) == 0) {
      uint16_t fmt, ch, block, bits;
      uint32_t rate, brate;
      if (sz < 16) return -3;
      fread(&fmt, 2, 1, f);
      fread(&ch, 2, 1, f);
      fread(&rate, 4, 1, f);
      fread(&brate, 4, 1, f);
      fread(&block, 2, 1, f);
      fread(&bits, 2, 1, f);
      if (sz > 16) fseek(f, sz - 16, SEEK_CUR);
      info->format = fmt;
      info->channels = ch;
      info->sample_rate = (int)rate;
      info->bits = bits;
    } else if (memcmp(id, "data", 4) == 0) {
      info->data_offset = ftell(f);
      info->data_bytes = sz;
      return 0;
    } else {
      fseek(f, sz + (sz & 1), SEEK_CUR);
    }
  }
  return -4;
}

// Decode interleaved frames -> mono float64 (mean over channels, the
// librosa to_mono convention).
int decode_to_mono(FILE* f, const WavInfo& info, std::vector<double>* mono) {
  const int ch = info.channels;
  if (ch <= 0 || info.sample_rate <= 0) return -5;
  const long bytes_per_sample = info.bits / 8;
  const long n_frames = info.data_bytes / (bytes_per_sample * ch);
  mono->resize(n_frames);
  fseek(f, info.data_offset, SEEK_SET);
  std::vector<uint8_t> buf((size_t)info.data_bytes);
  if (fread(buf.data(), 1, (size_t)info.data_bytes, f) !=
      (size_t)info.data_bytes)
    return -6;
  const uint8_t* p = buf.data();
  for (long i = 0; i < n_frames; ++i) {
    double acc = 0.0;
    for (int c = 0; c < ch; ++c) {
      const uint8_t* s = p + (i * ch + c) * bytes_per_sample;
      double v = 0.0;
      if (info.format == 1 && info.bits == 16) {
        int16_t x;
        memcpy(&x, s, 2);
        v = x / 32768.0;
      } else if (info.format == 1 && info.bits == 24) {
        int32_t x = (s[0] << 8) | (s[1] << 16) | ((int32_t)(int8_t)s[2] << 24);
        v = (x >> 8) / 8388608.0;
      } else if (info.format == 1 && info.bits == 32) {
        int32_t x;
        memcpy(&x, s, 4);
        v = x / 2147483648.0;
      } else if (info.format == 3 && info.bits == 32) {
        float x;
        memcpy(&x, s, 4);
        v = x;
      } else if (info.format == 3 && info.bits == 64) {
        double x;
        memcpy(&x, s, 8);
        v = x;
      } else {
        return -7;  // unsupported encoding
      }
      acc += v;
    }
    (*mono)[i] = acc / ch;
  }
  return 0;
}

// Polyphase windowed-sinc resampler (Kaiser-windowed, zero-phase FIR),
// band-limited to min(in, out) Nyquist.
void sinc_resample(const double* in, long in_len, int in_sr, int out_sr,
                   std::vector<float>* out) {
  if (in_sr == out_sr) {
    out->resize(in_len);
    for (long i = 0; i < in_len; ++i) (*out)[i] = (float)in[i];
    return;
  }
  const double ratio = (double)out_sr / in_sr;
  const long out_len = (long)llround((double)in_len * ratio);
  out->resize(out_len);
  // ideal lowpass h(t) = 2 fc sinc(2 fc t), fc in cycles per INPUT sample:
  // 0.5 * min(ratio, 1) * rolloff (anti-aliasing for downsampling)
  const int half_zeros = 32;  // sinc zero-crossings per side
  const double fc = 0.5 * (ratio < 1.0 ? ratio : 1.0) * 0.975;
  const double beta = 8.0;    // Kaiser beta ~ 80 dB stopband
  auto bessel_i0 = [](double x) {
    double sum = 1.0, term = 1.0;
    for (int k = 1; k < 64; ++k) {
      term *= (x / (2.0 * k)) * (x / (2.0 * k));
      sum += term;
      if (term < 1e-14 * sum) break;
    }
    return sum;
  };
  const double i0b = bessel_i0(beta);
  const double width = half_zeros / (2.0 * fc);  // support in input samples
  for (long j = 0; j < out_len; ++j) {
    const double center = j / ratio;
    const long lo = (long)ceil(center - width);
    const long hi = (long)floor(center + width);
    double acc = 0.0;
    for (long i = (lo < 0 ? 0 : lo); i <= hi && i < in_len; ++i) {
      const double t = i - center;            // input samples
      const double x = 2.0 * fc * t;          // sinc argument (zeros at ints)
      const double sinc = (fabs(x) < 1e-12) ? 1.0 : sin(kPi * x) / (kPi * x);
      const double u = x / half_zeros;        // window position in [-1, 1]
      if (u <= -1.0 || u >= 1.0) continue;
      const double win = bessel_i0(beta * sqrt(1.0 - u * u)) / i0b;
      acc += in[i] * (2.0 * fc * sinc * win);
    }
    (*out)[j] = (float)acc;
  }
}

// ---------------------------------------------------------------------------
// libmpg123 binding (dlopen; the mpg123 C ABI has been stable since 1.0).
// Constants below mirror mpg123.h:
//   enum mpg123_errors: MPG123_DONE = -12, MPG123_NEW_FORMAT = -11,
//                       MPG123_OK = 0
//   enum mpg123_enc_enum: MPG123_ENC_FLOAT_32 = 0x200
//   enum mpg123_parms:  MPG123_ADD_FLAGS = 2
//   enum mpg123_param_flags: MPG123_QUIET = 0x20, MPG123_GAPLESS = 0x40
// ---------------------------------------------------------------------------

constexpr int kMpgDone = -12;
constexpr int kMpgNewFormat = -11;
constexpr int kMpgOk = 0;
constexpr int kEncFloat32 = 0x200;
constexpr int kParmAddFlags = 2;
constexpr long kFlagQuiet = 0x20;
constexpr long kFlagGapless = 0x40;

struct Mpg123Api {
  void* dl = nullptr;
  int (*init)() = nullptr;
  void* (*make)(const char*, int*) = nullptr;              // mpg123_new
  void (*del)(void*) = nullptr;                            // mpg123_delete
  int (*param)(void*, int, long, double) = nullptr;
  int (*open)(void*, const char*) = nullptr;
  int (*close)(void*) = nullptr;
  int (*getformat)(void*, long*, int*, int*) = nullptr;
  int (*format_none)(void*) = nullptr;
  int (*format)(void*, long, int, int) = nullptr;
  int (*read)(void*, unsigned char*, size_t, size_t*) = nullptr;
  bool ok() const {
    return dl && init && make && del && open && close && getformat &&
           format_none && format && read;
  }
};

const Mpg123Api* get_mpg123() {
  static Mpg123Api api;
  static bool tried = false;
  if (tried) return api.ok() ? &api : nullptr;
  tried = true;
  const char* candidates[] = {"libmpg123.so.0", "libmpg123.so"};
  for (const char* name : candidates) {
    api.dl = dlopen(name, RTLD_NOW | RTLD_LOCAL);
    if (api.dl) break;
  }
  if (!api.dl) return nullptr;
  auto sym = [&](const char* s) { return dlsym(api.dl, s); };
  api.init = (int (*)())sym("mpg123_init");
  api.make = (void* (*)(const char*, int*))sym("mpg123_new");
  api.del = (void (*)(void*))sym("mpg123_delete");
  api.param = (int (*)(void*, int, long, double))sym("mpg123_param");
  api.open = (int (*)(void*, const char*))sym("mpg123_open");
  api.close = (int (*)(void*))sym("mpg123_close");
  api.getformat = (int (*)(void*, long*, int*, int*))sym("mpg123_getformat");
  api.format_none = (int (*)(void*))sym("mpg123_format_none");
  api.format = (int (*)(void*, long, int, int))sym("mpg123_format");
  api.read = (int (*)(void*, unsigned char*, size_t, size_t*))
      sym("mpg123_read");
  if (!api.ok()) return nullptr;
  api.init();  // no-op in modern mpg123, required before 1.27
  return &api;
}

}  // namespace

extern "C" {

int audioio_load_wav(const char* path, int target_sr, float* out,
                     long out_capacity, long* out_len) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  int rc = parse_wav_header(f, &info);
  if (rc != 0) {
    fclose(f);
    return rc;
  }
  std::vector<double> mono;
  rc = decode_to_mono(f, info, &mono);
  fclose(f);
  if (rc != 0) return rc;
  std::vector<float> res;
  sinc_resample(mono.data(), (long)mono.size(), info.sample_rate,
                target_sr > 0 ? target_sr : info.sample_rate, &res);
  long n = (long)res.size();
  if (n > out_capacity) n = out_capacity;
  memcpy(out, res.data(), n * sizeof(float));
  *out_len = n;
  return 0;
}

// Error codes: -20 libmpg123 unavailable, -21 open failed, -22 bad format,
// -23 decode error.
int audioio_load_mp3(const char* path, int target_sr, double max_seconds,
                     float* out, long out_capacity, long* out_len) {
  const Mpg123Api* mpg = get_mpg123();
  if (!mpg) return -20;
  int err = 0;
  void* h = mpg->make(nullptr, &err);
  if (!h) return -20;
  if (mpg->param) mpg->param(h, kParmAddFlags, kFlagQuiet | kFlagGapless, 0.0);
  // The output format is negotiated at open(): restrict the accepted set to
  // float32 (any MPEG rate, mono or stereo) BEFORE opening; we downmix and
  // resample ourselves (same path as wav).
  mpg->format_none(h);
  constexpr long kMpegRates[] = {8000,  11025, 12000, 16000, 22050,
                                 24000, 32000, 44100, 48000};
  for (long r : kMpegRates) {
    if (mpg->format(h, r, /*MPG123_MONO|MPG123_STEREO=*/3, kEncFloat32) !=
        kMpgOk) {
      mpg->del(h);
      return -22;
    }
  }
  if (mpg->open(h, path) != kMpgOk) {
    mpg->del(h);
    return -21;
  }
  long rate = 0;
  int channels = 0, encoding = 0;
  if (mpg->getformat(h, &rate, &channels, &encoding) != kMpgOk ||
      rate <= 0 || channels <= 0 || encoding != kEncFloat32) {
    mpg->close(h);
    mpg->del(h);
    return -22;
  }
  long max_frames =
      max_seconds > 0 ? (long)llround(max_seconds * rate) + 1 : -1;
  std::vector<float> pcm;  // interleaved
  std::vector<unsigned char> buf(1 << 16);
  int rc = kMpgOk;
  while (true) {
    size_t done = 0;
    rc = mpg->read(h, buf.data(), buf.size(), &done);
    if (done > 0) {
      const float* p = reinterpret_cast<const float*>(buf.data());
      pcm.insert(pcm.end(), p, p + done / sizeof(float));
    }
    if (rc == kMpgDone) break;
    if (rc == kMpgNewFormat) {
      // Stream parameter change. A change BEFORE any decoded audio is the
      // normal open sequence — re-query and continue. A change AFTER audio
      // has been decoded (stitched/re-encoded files) would reinterpret the
      // already-buffered interleaved PCM under the new channel count and
      // resample it at the wrong rate: fail the decode instead (rc -24 ->
      // the pipeline's skip-and-record policy), never return corrupt audio
      // with rc=0.
      long new_rate = 0;
      int new_channels = 0;
      if (mpg->getformat(h, &new_rate, &new_channels, &encoding) != kMpgOk)
        break;
      if (!pcm.empty() && (new_rate != rate || new_channels != channels)) {
        mpg->close(h);
        mpg->del(h);
        return -24;
      }
      rate = new_rate;
      channels = new_channels;
      if (max_seconds > 0)
        max_frames = (long)llround(max_seconds * rate) + 1;
      continue;
    }
    if (rc != kMpgOk) break;
    if (max_frames > 0 && (long)(pcm.size() / channels) >= max_frames) break;
  }
  mpg->close(h);
  mpg->del(h);
  const long n_frames = (long)(pcm.size() / channels);
  if (n_frames == 0) return -23;
  std::vector<double> mono(n_frames);
  for (long i = 0; i < n_frames; ++i) {
    double acc = 0.0;
    for (int c = 0; c < channels; ++c) acc += pcm[i * channels + c];
    mono[i] = acc / channels;
  }
  long use = n_frames;
  if (max_frames > 0 && use > max_frames) use = max_frames;
  std::vector<float> res;
  sinc_resample(mono.data(), use, (int)rate,
                target_sr > 0 ? target_sr : (int)rate, &res);
  long n = (long)res.size();
  if (n > out_capacity) n = out_capacity;
  memcpy(out, res.data(), n * sizeof(float));
  *out_len = n;
  return 0;
}

int audioio_resample(const float* in, long in_len, int in_sr, int out_sr,
                     float* out, long out_capacity, long* out_len) {
  std::vector<double> tmp(in_len);
  for (long i = 0; i < in_len; ++i) tmp[i] = in[i];
  std::vector<float> res;
  sinc_resample(tmp.data(), in_len, in_sr, out_sr, &res);
  long n = (long)res.size();
  if (n > out_capacity) n = out_capacity;
  memcpy(out, res.data(), n * sizeof(float));
  *out_len = n;
  return 0;
}

}  // extern "C"
