// framereader: native frame decoding for the video IO layer.
//
// The host-side hot loop of the analysis pipeline is container decode:
// seeking frames in a Y4M stream and converting YUV420 -> interleaved RGB
// before shipping uint8 frames to the device. The Python/numpy fallback
// (video/containers.py) allocates several temporaries per frame; this C++
// implementation does the conversion in one pass with integer arithmetic
// and writes straight into a caller-provided buffer (which Python moves to
// the device with no further copies).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11). The port's
// copy of the JAX package's native/framereader.cpp, unchanged below this
// header; video/native_reader.py builds it with
// g++ -O3 -fPIC -shared -std=c++17 into build/vtx_host/ at first use.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Parse a Y4M header. Returns header length in bytes, or -1 on error.
// Fills width, height, fps_num, fps_den.
int y4m_parse_header(const char* data, int64_t size, int32_t* width,
                     int32_t* height, int32_t* fps_num, int32_t* fps_den) {
  static const char kMagic[] = "YUV4MPEG2";
  if (size < 10 || std::memcmp(data, kMagic, 9) != 0) return -1;

  *width = 0;
  *height = 0;
  *fps_num = 30;
  *fps_den = 1;

  int64_t i = 9;
  while (i < size && data[i] != '\n') {
    if (data[i] == ' ') {
      ++i;
      if (i >= size) break;
      char tag = data[i];
      ++i;
      int64_t start = i;
      while (i < size && data[i] != ' ' && data[i] != '\n') ++i;
      char buf[32];
      int64_t len = i - start;
      if (len <= 0 || len >= (int64_t)sizeof(buf)) continue;
      std::memcpy(buf, data + start, len);
      buf[len] = '\0';
      switch (tag) {
        case 'W': *width = std::atoi(buf); break;
        case 'H': *height = std::atoi(buf); break;
        case 'F': {
          int n = 30, d = 1;
          if (std::sscanf(buf, "%d:%d", &n, &d) == 2 && d > 0) {
            *fps_num = n;
            *fps_den = d;
          }
          break;
        }
        default: break;
      }
    } else {
      ++i;
    }
  }
  if (i >= size || *width <= 0 || *height <= 0) return -1;
  return (int)(i + 1);  // include the '\n'
}

namespace {

inline uint8_t clamp_u8(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// BT.601-ish full-range YUV -> RGB in 16.16 fixed point, matching the
// coefficients used by the Python fallback (containers._yuv420_to_rgb).
//
// Structured for auto-vectorization on one host core: per row, (1) chroma
// terms are computed at chroma resolution and duplicated to full width,
// (2) the per-pixel add+clamp runs over stride-1 int16 buffers (gcc emits
// saturating packs), (3) a final pass interleaves the planar rows. All
// intermediate terms fit int16: y in [0,255], radd in [-179,178],
// gsub in [-136,135], badd in [-227,226].
void yuv420_frame_to_rgb(const uint8_t* y_plane, const uint8_t* u_plane,
                         const uint8_t* v_plane, int width, int height,
                         uint8_t* rgb_out) {
  const int half_w = width / 2;
  std::vector<int16_t> radd(width), gsub(width), badd(width);
  std::vector<uint8_t> r(width), g(width), b(width);
  for (int row = 0; row < height; ++row) {
    const uint8_t* y_row = y_plane + (int64_t)row * width;
    const uint8_t* u_row = u_plane + (int64_t)(row / 2) * half_w;
    const uint8_t* v_row = v_plane + (int64_t)(row / 2) * half_w;
    uint8_t* out = rgb_out + (int64_t)row * width * 3;

    if ((row & 1) == 0) {  // chroma rows repeat for two luma rows
      for (int c = 0; c < half_w; ++c) {
        const int u_val = u_row[c] - 128;
        const int v_val = v_row[c] - 128;
        // 1.402 -> 91881/65536; 0.344136 -> 22554; 0.714136 -> 46802;
        // 1.772 -> 116130.
        const int16_t ra = (int16_t)((91881 * v_val) >> 16);
        const int16_t gs = (int16_t)((22554 * u_val + 46802 * v_val) >> 16);
        const int16_t ba = (int16_t)((116130 * u_val) >> 16);
        radd[2 * c] = ra;
        radd[2 * c + 1] = ra;
        gsub[2 * c] = gs;
        gsub[2 * c + 1] = gs;
        badd[2 * c] = ba;
        badd[2 * c + 1] = ba;
      }
    }
    for (int col = 0; col < width; ++col) {
      const int16_t y_val = (int16_t)y_row[col];
      r[col] = clamp_u8(y_val + radd[col]);
      g[col] = clamp_u8(y_val - gsub[col]);
      b[col] = clamp_u8(y_val + badd[col]);
    }
    for (int col = 0; col < width; ++col) {
      out[3 * col + 0] = r[col];
      out[3 * col + 1] = g[col];
      out[3 * col + 2] = b[col];
    }
  }
}

}  // namespace

// Decode selected frames from an in-memory Y4M buffer into rgb_out
// (uint8, [num_indices, height, width, 3], caller-allocated).
// indices are frame numbers. Returns number of frames written, -1 on error.
int y4m_decode_frames(const char* data, int64_t size, const int64_t* indices,
                      int32_t num_indices, uint8_t* rgb_out) {
  int32_t width, height, fps_num, fps_den;
  const int header_len =
      y4m_parse_header(data, size, &width, &height, &fps_num, &fps_den);
  // Odd dims would make the 4:2:0 chroma indexing read past the chroma
  // planes (untrusted input); the Python caller falls back to numpy.
  if (header_len < 0 || width % 2 || height % 2) return -1;

  const int64_t y_size = (int64_t)width * height;
  const int64_t c_size = y_size / 4;
  const int64_t frame_payload = y_size + 2 * c_size;
  const int64_t frame_stride = 6 /* "FRAME\n" */ + frame_payload;
  const int64_t num_frames = (size - header_len) / frame_stride;
  const int64_t frame_rgb = (int64_t)width * height * 3;

  for (int32_t i = 0; i < num_indices; ++i) {
    int64_t idx = indices[i];
    if (idx < 0 || idx >= num_frames) return -1;
    const char* frame = data + header_len + idx * frame_stride;
    if (std::memcmp(frame, "FRAME", 5) != 0) return -1;
    const uint8_t* payload = (const uint8_t*)(frame + 6);
    yuv420_frame_to_rgb(payload, payload + y_size, payload + y_size + c_size,
                        width, height, rgb_out + (int64_t)i * frame_rgb);
  }
  return num_indices;
}

// Fused subsample: decode frames and average-pool 2x2 (halving H and W)
// in the same pass — used when the target resolution is far below source,
// cutting host->device transfer bytes by 4x before the on-device resize.
int y4m_decode_frames_pooled(const char* data, int64_t size,
                             const int64_t* indices, int32_t num_indices,
                             uint8_t* rgb_out) {
  int32_t width, height, fps_num, fps_den;
  const int header_len =
      y4m_parse_header(data, size, &width, &height, &fps_num, &fps_den);
  if (header_len < 0 || width % 2 || height % 2) return -1;

  const int64_t y_size = (int64_t)width * height;
  const int64_t c_size = y_size / 4;
  const int64_t frame_stride = 6 + y_size + 2 * c_size;
  const int64_t num_frames = (size - header_len) / frame_stride;
  const int out_w = width / 2, out_h = height / 2;
  const int64_t frame_rgb = (int64_t)out_w * out_h * 3;
  const int half_w = width / 2;

  for (int32_t i = 0; i < num_indices; ++i) {
    int64_t idx = indices[i];
    if (idx < 0 || idx >= num_frames) return -1;
    const char* frame = data + header_len + idx * frame_stride;
    if (std::memcmp(frame, "FRAME", 5) != 0) return -1;
    const uint8_t* y_plane = (const uint8_t*)(frame + 6);
    const uint8_t* u_plane = y_plane + y_size;
    const uint8_t* v_plane = u_plane + c_size;
    uint8_t* out_frame = rgb_out + (int64_t)i * frame_rgb;

    // Same vectorization layout as yuv420_frame_to_rgb: planar stride-1
    // arithmetic passes, then one interleave pass.
    std::vector<int16_t> ypool(out_w);
    std::vector<uint8_t> r(out_w), g(out_w), b(out_w);
    for (int row = 0; row < out_h; ++row) {
      const uint8_t* y0 = y_plane + (int64_t)(2 * row) * width;
      const uint8_t* y1 = y0 + width;
      const uint8_t* u_row = u_plane + (int64_t)row * half_w;
      const uint8_t* v_row = v_plane + (int64_t)row * half_w;
      uint8_t* out = out_frame + (int64_t)row * out_w * 3;
      for (int col = 0; col < out_w; ++col) {
        // 2x2 luma average; chroma is already at this resolution (420).
        ypool[col] = (int16_t)((y0[2 * col] + y0[2 * col + 1] +
                                y1[2 * col] + y1[2 * col + 1] + 2) >> 2);
      }
      for (int col = 0; col < out_w; ++col) {
        const int u_val = u_row[col] - 128;
        const int v_val = v_row[col] - 128;
        const int16_t y_val = ypool[col];
        r[col] = clamp_u8(y_val + (int16_t)((91881 * v_val) >> 16));
        g[col] = clamp_u8(y_val - (int16_t)((22554 * u_val + 46802 * v_val) >> 16));
        b[col] = clamp_u8(y_val + (int16_t)((116130 * u_val) >> 16));
      }
      for (int col = 0; col < out_w; ++col) {
        out[3 * col + 0] = r[col];
        out[3 * col + 1] = g[col];
        out[3 * col + 2] = b[col];
      }
    }
  }
  return num_indices;
}

}  // extern "C"
