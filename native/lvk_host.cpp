// Native host runtime for livevisionkit_tpu.
//
// Reference parity: the reference's ingest + pipeline layers are native C++
// (Modules/OBS-Plugin/Interop/FrameIngest.cpp bulk plane codecs;
// LiveVisionKit/Filters/VideoFilter.cpp:62-209 bounded-queue pipeline).
// This library provides the host-side equivalents for the JAX runtime:
//
//   * packed->planar pixel-format converters (YUY2/UYVY deinterleave, NV12
//     chroma split, BGR HWC->planar split) written as tight -O3 loops the
//     compiler auto-vectorizes; they feed jax.device_put with contiguous
//     planes so the device never sees packed layouts.
//   * a lock-free single-producer/single-consumer frame ring buffer for the
//     decode->dispatch handoff (the reference's 15-deep condvar queues,
//     without locks).
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this environment).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

extern "C" {

// ---------------------------------------------------------------------------
// pixel-format converters
// ---------------------------------------------------------------------------

// YUYV packed (h x w x 2 bytes) -> Y (h*w), U (h*w/2), V (h*w/2)
void lvk_unpack_yuy2(const uint8_t* src, uint8_t* y, uint8_t* u, uint8_t* v,
                     int64_t w, int64_t h) {
  const int64_t pairs = (w / 2);
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t* s = src + r * w * 2;
    uint8_t* yr = y + r * w;
    uint8_t* ur = u + r * pairs;
    uint8_t* vr = v + r * pairs;
    for (int64_t p = 0; p < pairs; ++p) {
      yr[2 * p] = s[4 * p + 0];
      ur[p] = s[4 * p + 1];
      yr[2 * p + 1] = s[4 * p + 2];
      vr[p] = s[4 * p + 3];
    }
  }
}

// UYVY packed -> planes
void lvk_unpack_uyvy(const uint8_t* src, uint8_t* y, uint8_t* u, uint8_t* v,
                     int64_t w, int64_t h) {
  const int64_t pairs = (w / 2);
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t* s = src + r * w * 2;
    uint8_t* yr = y + r * w;
    uint8_t* ur = u + r * pairs;
    uint8_t* vr = v + r * pairs;
    for (int64_t p = 0; p < pairs; ++p) {
      ur[p] = s[4 * p + 0];
      yr[2 * p] = s[4 * p + 1];
      vr[p] = s[4 * p + 2];
      yr[2 * p + 1] = s[4 * p + 3];
    }
  }
}

// NV12 interleaved chroma (h/2 x w/2 x 2) -> U, V planes
void lvk_split_nv12(const uint8_t* uv, uint8_t* u, uint8_t* v, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    u[i] = uv[2 * i];
    v[i] = uv[2 * i + 1];
  }
}

// ---- egress packers (download halves of the reference's FrameIngest
// codecs, Modules/OBS-Plugin/Interop/FrameIngest.cpp:145-217) -------------

// Y (h*w), U (h*w/2), V (h*w/2) -> YUYV packed (h x w x 2 bytes)
void lvk_pack_yuy2(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                   uint8_t* dst, int64_t w, int64_t h) {
  const int64_t pairs = (w / 2);
  for (int64_t r = 0; r < h; ++r) {
    uint8_t* d = dst + r * w * 2;
    const uint8_t* yr = y + r * w;
    const uint8_t* ur = u + r * pairs;
    const uint8_t* vr = v + r * pairs;
    for (int64_t p = 0; p < pairs; ++p) {
      d[4 * p + 0] = yr[2 * p];
      d[4 * p + 1] = ur[p];
      d[4 * p + 2] = yr[2 * p + 1];
      d[4 * p + 3] = vr[p];
    }
  }
}

// planes -> UYVY packed
void lvk_pack_uyvy(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                   uint8_t* dst, int64_t w, int64_t h) {
  const int64_t pairs = (w / 2);
  for (int64_t r = 0; r < h; ++r) {
    uint8_t* d = dst + r * w * 2;
    const uint8_t* yr = y + r * w;
    const uint8_t* ur = u + r * pairs;
    const uint8_t* vr = v + r * pairs;
    for (int64_t p = 0; p < pairs; ++p) {
      d[4 * p + 0] = ur[p];
      d[4 * p + 1] = yr[2 * p];
      d[4 * p + 2] = vr[p];
      d[4 * p + 3] = yr[2 * p + 1];
    }
  }
}

// U, V planes -> NV12 interleaved chroma (n = plane elements)
void lvk_interleave_nv12(const uint8_t* u, const uint8_t* v, uint8_t* uv,
                         int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uv[2 * i] = u[i];
    uv[2 * i + 1] = v[i];
  }
}

// HWC uint8 (h x w x 3) -> planar CHW uint8
void lvk_hwc_to_planar(const uint8_t* src, uint8_t* dst, int64_t w, int64_t h) {
  const int64_t plane = w * h;
  for (int64_t i = 0; i < plane; ++i) {
    dst[i] = src[3 * i];
    dst[plane + i] = src[3 * i + 1];
    dst[2 * plane + i] = src[3 * i + 2];
  }
}

// planar CHW uint8 -> HWC uint8 (egress)
void lvk_planar_to_hwc(const uint8_t* src, uint8_t* dst, int64_t w, int64_t h) {
  const int64_t plane = w * h;
  for (int64_t i = 0; i < plane; ++i) {
    dst[3 * i] = src[i];
    dst[3 * i + 1] = src[plane + i];
    dst[3 * i + 2] = src[2 * plane + i];
  }
}

// planar CHW float32 [0,1] -> HWC uint8 (egress with quantization)
void lvk_planar_f32_to_hwc_u8(const float* src, uint8_t* dst, int64_t w,
                              int64_t h, int64_t c) {
  const int64_t plane = w * h;
  for (int64_t i = 0; i < plane; ++i) {
    for (int64_t ch = 0; ch < c; ++ch) {
      float x = src[ch * plane + i] * 255.0f + 0.5f;
      x = x < 0.0f ? 0.0f : (x > 255.0f ? 255.0f : x);
      dst[c * i + ch] = (uint8_t)x;
    }
  }
}

// ---------------------------------------------------------------------------
// SPSC frame ring (decode -> dispatch handoff)
// ---------------------------------------------------------------------------

struct LvkRing {
  uint8_t* storage;
  int64_t capacity;     // number of slots
  int64_t frame_bytes;  // bytes per slot
  std::atomic<int64_t> head;  // next write (producer)
  std::atomic<int64_t> tail;  // next read (consumer)
};

void* lvk_ring_create(int64_t capacity, int64_t frame_bytes) {
  auto* r = new (std::nothrow) LvkRing;
  if (!r) return nullptr;
  r->storage = new (std::nothrow) uint8_t[capacity * frame_bytes];
  if (!r->storage) {
    delete r;
    return nullptr;
  }
  r->capacity = capacity;
  r->frame_bytes = frame_bytes;
  r->head.store(0);
  r->tail.store(0);
  return r;
}

void lvk_ring_destroy(void* ring) {
  auto* r = static_cast<LvkRing*>(ring);
  if (!r) return;
  delete[] r->storage;
  delete r;
}

int64_t lvk_ring_size(void* ring) {
  auto* r = static_cast<LvkRing*>(ring);
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

// Returns 1 on success, 0 if full (non-blocking).
int lvk_ring_push(void* ring, const uint8_t* frame) {
  auto* r = static_cast<LvkRing*>(ring);
  const int64_t head = r->head.load(std::memory_order_relaxed);
  const int64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= r->capacity) return 0;
  std::memcpy(r->storage + (head % r->capacity) * r->frame_bytes, frame,
              r->frame_bytes);
  r->head.store(head + 1, std::memory_order_release);
  return 1;
}

// Returns 1 on success, 0 if empty (non-blocking).
int lvk_ring_pop(void* ring, uint8_t* out) {
  auto* r = static_cast<LvkRing*>(ring);
  const int64_t tail = r->tail.load(std::memory_order_relaxed);
  const int64_t head = r->head.load(std::memory_order_acquire);
  if (head == tail) return 0;
  std::memcpy(out, r->storage + (tail % r->capacity) * r->frame_bytes,
              r->frame_bytes);
  r->tail.store(tail + 1, std::memory_order_release);
  return 1;
}

}  // extern "C"
