// avtex_torch host runtime: RIFF/AVI muxer (MJPEG video + PCM audio).
//
// The in-process writer of the port's AVI files. Its byte layout is that of
// the pure-Python writer in avtex_torch/media/avimux.py (write_avi_python,
// the plain version); this one builds the file in one buffer and writes it
// once. avtex_torch/native/muxer.py binds it.
//
// C ABI only: bound from Python with ctypes.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kAvifHasIndex = 0x00000010;
constexpr uint32_t kAviifKeyframe = 0x00000010;

struct Buf {
  std::vector<uint8_t> d;
  void raw(const void* p, size_t n) {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    d.insert(d.end(), b, b + n);
  }
  void fourcc(const char* s) { raw(s, 4); }
  void u16(uint16_t v) { raw(&v, 2); }
  void u32(uint32_t v) { raw(&v, 4); }
  void i32(int32_t v) { raw(&v, 4); }
  void i16(int16_t v) { raw(&v, 2); }
  void chunk(const char* cc, const Buf& payload) {
    fourcc(cc);
    u32(static_cast<uint32_t>(payload.d.size()));
    raw(payload.d.data(), payload.d.size());
    if (payload.d.size() % 2) d.push_back(0);
  }
  void list(const char* cc, const Buf& payload) {
    fourcc("LIST");
    u32(static_cast<uint32_t>(payload.d.size() + 4));
    fourcc(cc);
    raw(payload.d.data(), payload.d.size());
    if ((payload.d.size() + 4) % 2) d.push_back(0);
  }
};

}  // namespace

extern "C" {

// Returns 0 on success, negative errno-style codes on failure.
int avtex_write_avi(const char* path,
                    const uint8_t* const* jpegs, const int32_t* jpeg_sizes,
                    int32_t n_frames, int32_t width, int32_t height,
                    double fps,
                    const int16_t* pcm, int64_t n_samples, int32_t channels,
                    int32_t sample_rate) {
  if (n_frames <= 0 || fps <= 0.0) return -1;
  const bool has_audio = pcm != nullptr && n_samples > 0 && channels > 0;

  int32_t max_jpeg = 0;
  for (int32_t i = 0; i < n_frames; ++i)
    if (jpeg_sizes[i] > max_jpeg) max_jpeg = jpeg_sizes[i];

  const uint32_t usec_per_frame =
      static_cast<uint32_t>(1e6 / fps + 0.5);
  const int64_t samples_per_frame =
      has_audio ? static_cast<int64_t>(sample_rate / fps + 0.5) : 0;
  const int32_t block_align = 2 * channels;

  // ---- hdrl ---------------------------------------------------------- //
  Buf avih;
  avih.u32(usec_per_frame); avih.u32(0); avih.u32(0);
  avih.u32(kAvifHasIndex);
  avih.u32(static_cast<uint32_t>(n_frames)); avih.u32(0);
  avih.u32(has_audio ? 2 : 1);
  avih.u32(static_cast<uint32_t>(max_jpeg));
  avih.u32(static_cast<uint32_t>(width));
  avih.u32(static_cast<uint32_t>(height));
  for (int i = 0; i < 4; ++i) avih.u32(0);

  const uint32_t scale = 1000;
  const uint32_t rate = static_cast<uint32_t>(fps * 1000 + 0.5);

  Buf strh_v;
  strh_v.fourcc("vids"); strh_v.fourcc("MJPG");
  strh_v.u32(0); strh_v.u16(0); strh_v.u16(0); strh_v.u32(0);
  strh_v.u32(scale); strh_v.u32(rate); strh_v.u32(0);
  strh_v.u32(static_cast<uint32_t>(n_frames));
  strh_v.u32(static_cast<uint32_t>(max_jpeg));
  strh_v.i32(-1); strh_v.u32(0);
  strh_v.i16(0); strh_v.i16(0);
  strh_v.i16(static_cast<int16_t>(width));
  strh_v.i16(static_cast<int16_t>(height));

  Buf strf_v;
  strf_v.u32(40); strf_v.i32(width); strf_v.i32(height);
  strf_v.u16(1); strf_v.u16(24); strf_v.fourcc("MJPG");
  strf_v.u32(static_cast<uint32_t>(width) * height * 3);
  strf_v.i32(0); strf_v.i32(0); strf_v.u32(0); strf_v.u32(0);

  Buf strl_v_payload;
  strl_v_payload.chunk("strh", strh_v);
  strl_v_payload.chunk("strf", strf_v);

  Buf strls;
  strls.list("strl", strl_v_payload);

  if (has_audio) {
    Buf strh_a;
    strh_a.fourcc("auds");
    strh_a.u32(0);  // handler
    strh_a.u32(0); strh_a.u16(0); strh_a.u16(0); strh_a.u32(0);
    strh_a.u32(1); strh_a.u32(static_cast<uint32_t>(sample_rate));
    strh_a.u32(0);
    strh_a.u32(static_cast<uint32_t>(n_samples));
    strh_a.u32(static_cast<uint32_t>(samples_per_frame * block_align));
    strh_a.i32(-1);
    strh_a.u32(static_cast<uint32_t>(block_align));
    strh_a.i16(0); strh_a.i16(0); strh_a.i16(0); strh_a.i16(0);

    Buf strf_a;
    strf_a.u16(1);  // PCM
    strf_a.u16(static_cast<uint16_t>(channels));
    strf_a.u32(static_cast<uint32_t>(sample_rate));
    strf_a.u32(static_cast<uint32_t>(sample_rate * block_align));
    strf_a.u16(static_cast<uint16_t>(block_align));
    strf_a.u16(16); strf_a.u16(0);

    Buf strl_a_payload;
    strl_a_payload.chunk("strh", strh_a);
    strl_a_payload.chunk("strf", strf_a);
    strls.list("strl", strl_a_payload);
  }

  Buf hdrl_payload;
  hdrl_payload.chunk("avih", avih);
  hdrl_payload.raw(strls.d.data(), strls.d.size());

  // ---- movi + idx1 --------------------------------------------------- //
  Buf movi_payload;
  Buf index;
  auto emit = [&](const char* cc, const uint8_t* p, uint32_t n) {
    const uint32_t offset = 4 + static_cast<uint32_t>(movi_payload.d.size());
    Buf payload;
    payload.raw(p, n);
    movi_payload.chunk(cc, payload);
    index.fourcc(cc);
    index.u32(kAviifKeyframe);
    index.u32(offset);
    index.u32(n);
  };

  int64_t audio_pos = 0;
  for (int32_t i = 0; i < n_frames; ++i) {
    emit("00dc", jpegs[i], static_cast<uint32_t>(jpeg_sizes[i]));
    if (has_audio) {
      int64_t end = (i == n_frames - 1)
                        ? n_samples
                        : std::min<int64_t>(n_samples,
                                            (i + 1) * samples_per_frame);
      if (end > audio_pos) {
        emit("01wb",
             reinterpret_cast<const uint8_t*>(pcm + audio_pos * channels),
             static_cast<uint32_t>((end - audio_pos) * block_align));
        audio_pos = end;
      }
    }
  }

  Buf riff_payload;
  riff_payload.fourcc("AVI ");
  {
    Buf tmp;
    tmp.list("hdrl", hdrl_payload);
    tmp.list("movi", movi_payload);
    tmp.chunk("idx1", index);
    riff_payload.raw(tmp.d.data(), tmp.d.size());
  }

  FILE* f = std::fopen(path, "wb");
  if (!f) return -2;
  Buf out;
  out.chunk("RIFF", riff_payload);
  const size_t n = std::fwrite(out.d.data(), 1, out.d.size(), f);
  std::fclose(f);
  return n == out.d.size() ? 0 : -3;
}

const char* avtex_native_version() { return "avtex_torch-native 0.1.0"; }

}  // extern "C"
