// What both compositor kernels (csrc/composite_fwd.cu, composite_bwd.cu)
// share: the block shape, the alpha gates, a row's coefficients, the pixel
// coordinates of a thread, the staging of a chunk's rows, and phase 0,
// which tells each chunk of G instance rows its tile.
//
// Phase 0. Tile t owns rows [astarts[t], astarts[t] + counts[t]); astarts
// are multiples of G and non-empty segments are disjoint, as the binning
// lays them out. One block a tile writes rows[t], the segment's rows inside
// the array (0 for a segment that starts outside it, cut at the array's
// end), and, for each of the segment's chunks, chunk_tile[c] = t and
// chunk_j[c] = its index j in the segment. The caller fills chunk_tile and
// chunk_j with -1 first, so padding chunks keep -1. The plain version is
// `ops/rasterize_kernels.py::chunk_map`.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kFeat = 16;         // floats a row
constexpr int kThreads = 256;     // threads a block
constexpr int kPixPerThread = 4;  // P <= 1024
constexpr int kAhead = 8;         // chunks a scan loads before it works
constexpr int kMapThreads = 64;   // threads a phase-0 block
constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaSkip = 0.003921569f;  // float32(1 / 255)
constexpr float kStopT = 1e-4f;

// Per-row coefficients: the quadratic form's, the opacity and the colour,
// as both kernels form them.
struct Row {
  float mx, my, op, cr, cg, cb, c2, c3, c4, c5;
};

template <bool kConic>
__device__ __forceinline__ Row load_row(const float* f) {
  Row r;
  r.mx = f[0];
  r.my = f[1];
  r.op = f[6];
  r.cr = f[7];
  r.cg = f[8];
  r.cb = f[9];
  r.c2 = f[2];  // conic A; ellipse cos
  r.c3 = f[3];  // conic B; ellipse sin
  if (kConic) {
    r.c4 = f[4];  // C
    r.c5 = 0.0f;
  } else {
    r.c4 = 2.0f * f[4] * f[4] + 1e-8f;  // 2 sx^2 + 1e-8
    r.c5 = 2.0f * f[5] * f[5] + 1e-8f;  // 2 sy^2 + 1e-8
  }
  return r;
}

// Pixel coordinates of this thread's pixels in tile t.
template <bool kConic>
__device__ __forceinline__ void pixel_coords(const int* origins, int t, int tw,
                                             float* xs, float* ys) {
  constexpr float kPixelOffset = kConic ? 0.5f : 0.0f;
  const float y0 = static_cast<float>(origins[2 * t]);
  const float x0 = static_cast<float>(origins[2 * t + 1]);
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    xs[k] = x0 + static_cast<float>(p % tw) + kPixelOffset;
    ys[k] = y0 + static_cast<float>(p / tw) + kPixelOffset;
  }
}

// Copies chunk c's `nrows` rows into shared memory (16-byte loads).
__device__ __forceinline__ void stage_rows(float4* dst, const float* inst,
                                           long long c, int G, int nrows) {
  const float4* src =
      reinterpret_cast<const float4*>(inst + c * G * kFeat);
  for (int i = threadIdx.x; i < nrows * (kFeat / 4); i += kThreads) {
    dst[i] = src[i];
  }
  __syncthreads();
}

// Phase 0: the chunk map and each segment's rows in the array.
__global__ void __launch_bounds__(kMapThreads)
build_chunk_map(const int* __restrict__ astarts,
                const int* __restrict__ counts, long long n_rows, int G,
                int* __restrict__ chunk_tile, int* __restrict__ chunk_j,
                int* __restrict__ rows) {
  const int t = blockIdx.x;
  const long long start = astarts[t];
  const long long count = counts[t];
  const int n = (start >= 0 && start < n_rows && count > 0)
                    ? static_cast<int>(min(count, n_rows - start))
                    : 0;
  if (threadIdx.x == 0) rows[t] = n;
  const int steps = (n + G - 1) / G;
  const long long c0 = start / G;
  for (int j = threadIdx.x; j < steps; j += kMapThreads) {
    chunk_tile[c0 + j] = t;
    chunk_j[c0 + j] = j;
  }
}

// Fills the map with -1 and launches build_chunk_map on `s`; `map` holds
// chunk_tile, chunk_j (n_rows / G each) and rows (n_tiles). Returns the
// first CUDA error, or cudaSuccess.
inline cudaError_t launch_chunk_map(const int* astarts, const int* counts,
                                    long long n_rows, int G, int n_tiles,
                                    int* map, cudaStream_t s) {
  const long long n_chunks = n_rows / G;
  cudaError_t err =
      cudaMemsetAsync(map, 0xFF, 2 * n_chunks * sizeof(int), s);  // -1
  if (err != cudaSuccess) return err;
  build_chunk_map<<<n_tiles, kMapThreads, 0, s>>>(
      astarts, counts, n_rows, G, map, map + n_chunks, map + 2 * n_chunks);
  return cudaGetLastError();
}

}  // namespace
