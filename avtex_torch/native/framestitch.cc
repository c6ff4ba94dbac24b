// avtex_torch host runtime: frame stitching for texture synthesis.
//
// The gather of a walk's frames (with the reference's optional red position
// bar burned in) and the linear crossfade at jumps, each one pass over
// preallocated buffers. avtex_torch/synth/stitcher.py holds the numpy plain
// versions with the same semantics; avtex_torch/native/stitch.py binds these.
//
// C ABI only: bound from Python with ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// Gather frames by id into a contiguous output, optionally burning the
// position bar (rows [H-25, H-10) black, a 6-px red marker at the column
// id * W / total_input_frames). Returns -1 for an id outside the video.
int avtex_stitch_frames(const uint8_t* video, int64_t num_frames,
                        int64_t height, int64_t width,
                        const int64_t* frame_ids, int64_t n_out,
                        uint8_t* out, int32_t frames_bar,
                        int64_t total_input_frames) {
  const int64_t frame_sz = height * width * 3;
  for (int64_t i = 0; i < n_out; ++i) {
    const int64_t id = frame_ids[i];
    if (id < 0 || id >= num_frames) return -1;
    uint8_t* dst = out + i * frame_sz;
    std::memcpy(dst, video + id * frame_sz, frame_sz);
    if (frames_bar && height > 25) {
      const int64_t col =
          total_input_frames > 0 ? id * width / total_input_frames : 0;
      const int64_t lo = std::max<int64_t>(0, col - 3);
      const int64_t hi = std::min<int64_t>(width, col + 3);
      for (int64_t r = height - 25; r < height - 10; ++r) {
        uint8_t* row = dst + (r * width) * 3;
        std::memset(row, 0, width * 3);
        for (int64_t c = lo; c < hi; ++c) {
          row[c * 3 + 0] = 255;
          row[c * 3 + 1] = 0;
          row[c * 3 + 2] = 0;
        }
      }
    }
  }
  return 0;
}

// n_mid frames blended linearly between two frames at t = k / (n_mid + 1),
// k = 1..n_mid, in float32 and rounded half up: frame0 + t * (frame1 -
// frame0) + 0.5, truncated.
int avtex_crossfade(const uint8_t* frame0, const uint8_t* frame1,
                    int64_t height, int64_t width, int32_t n_mid,
                    uint8_t* out) {
  const int64_t n = height * width * 3;
  for (int32_t k = 1; k <= n_mid; ++k) {
    const float t = static_cast<float>(k) / (n_mid + 1);
    uint8_t* dst = out + static_cast<int64_t>(k - 1) * n;
    for (int64_t i = 0; i < n; ++i) {
      dst[i] = static_cast<uint8_t>(
          frame0[i] + t * (static_cast<float>(frame1[i]) - frame0[i]) + 0.5f);
    }
  }
  return 0;
}

}  // extern "C"
