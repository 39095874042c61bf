// Host-side frame decode for the data loader: a copy of the JAX package's
// native/fastio.cpp (the port imports nothing of that package).
//
// The per-frame uint8 -> float conversion and white-background mask
// extraction (a pixel is background iff its red channel equals 255) is the
// loader's hot loop. NumPy does it in three passes with temporaries; this
// does one pass, multi-threaded over camera views. It scales by
// r * (1.0f / 255.0f), which differs from NumPy's r / 255 by one ulp on 126
// of the 256 byte values. Bound with ctypes by
// pose_splatter_torch/data/native.py, which builds it with g++ into
// build/native/ at first use and keeps the NumPy versions beside it.

#include <cstdint>
#include <cstddef>
#include <thread>
#include <vector>

extern "C" {

// in:  [C, H, W, 3] uint8 frame (white background = 255,255,255)
// mask_out: [C, H, W] float32 (1.0 foreground, 0.0 background)
// img_out:  [C, H, W, 3] float32 in [0, 1]
void decode_frame(const uint8_t* in, int64_t C, int64_t H, int64_t W,
                  float* mask_out, float* img_out, int n_threads) {
  const float inv255 = 1.0f / 255.0f;
  const int64_t hw = H * W;

  auto work = [&](int64_t c0, int64_t c1) {
    for (int64_t c = c0; c < c1; ++c) {
      const uint8_t* src = in + c * hw * 3;
      float* m = mask_out + c * hw;
      float* dst = img_out + c * hw * 3;
      for (int64_t p = 0; p < hw; ++p) {
        const uint8_t r = src[3 * p];
        const uint8_t g = src[3 * p + 1];
        const uint8_t b = src[3 * p + 2];
        dst[3 * p] = r * inv255;
        dst[3 * p + 1] = g * inv255;
        dst[3 * p + 2] = b * inv255;
        m[p] = (r == 255) ? 0.0f : 1.0f;
      }
    }
  };

  if (n_threads <= 1 || C <= 1) {
    work(0, C);
    return;
  }
  int nt = n_threads < (int)C ? n_threads : (int)C;
  std::vector<std::thread> threads;
  int64_t per = (C + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t c0 = t * per;
    int64_t c1 = c0 + per < C ? c0 + per : C;
    if (c0 >= c1) break;
    threads.emplace_back(work, c0, c1);
  }
  for (auto& th : threads) th.join();
}

// Batched variant: frames [B, C, H, W, 3] -> masks [B, C, H, W],
// imgs [B, C, H, W, 3]; threads split over B*C planes.
void decode_frames(const uint8_t* in, int64_t B, int64_t C, int64_t H,
                   int64_t W, float* mask_out, float* img_out,
                   int n_threads) {
  decode_frame(in, B * C, H, W, mask_out, img_out, n_threads);
}

// White-out: frames [C, H, W, 3] uint8 (modified in place), masks
// [C, H, W] uint8; pixels with mask < 128 become white
// (write_images.py:90 semantics).
void white_out(uint8_t* frames, const uint8_t* masks, int64_t C, int64_t H,
               int64_t W, int n_threads) {
  const int64_t hw = H * W;
  auto work = [&](int64_t c0, int64_t c1) {
    for (int64_t c = c0; c < c1; ++c) {
      uint8_t* f = frames + c * hw * 3;
      const uint8_t* m = masks + c * hw;
      for (int64_t p = 0; p < hw; ++p) {
        if (m[p] < 128) {
          f[3 * p] = 255;
          f[3 * p + 1] = 255;
          f[3 * p + 2] = 255;
        }
      }
    }
  };
  if (n_threads <= 1 || C <= 1) {
    work(0, C);
    return;
  }
  int nt = n_threads < (int)C ? n_threads : (int)C;
  std::vector<std::thread> threads;
  int64_t per = (C + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t c0 = t * per;
    int64_t c1 = c0 + per < C ? c0 + per : C;
    if (c0 >= c1) break;
    threads.emplace_back(work, c0, c1);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
