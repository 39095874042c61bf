// Forward compositor over per-tile instance segments, for sm_90a.
//
// Replaces the TPU kernel `_fwd_kernel` (with its wrapper `_forward_call`)
// in pose_splatter_tpu/ops/rasterize_pallas.py: front-to-back alpha
// compositing of each pixel tile over its own contiguous segment of
// instance rows, in input order (2D "ellipse" mode) or depth order (3D
// "conic" mode). With a `tbounds` pointer it also stores each walked
// chunk's entry transmittance for the backward (csrc/composite_bwd.cu).
//
// Layout. `inst` is [n_rows, 16] float32: one 64-byte row per
// Gaussian-by-tile instance (the TPU's 128-lane row padding existed only
// for its DMA alignment). Tile t owns rows [astarts[t], astarts[t] +
// counts[t]); `origins[t]` = (y0, x0). Outputs: rgb [T, 3, P],
// alpha [T, P], jstop [T] (chunks of G rows walked), P = th * tw.
// Optional tbounds [n_rows / G, P]: before walking chunk j of tile t, the
// kernel writes that chunk's entry T of every pixel to row
// astarts[t] / G + j (astarts are multiples of G). The TPU's 8-sublane
// padding of that row is dropped. Unwalked rows are left as they are. A
// null pointer skips the store, so the eval path pays nothing for it.
//   ellipse: 0 mean_x, 1 mean_y, 2 cos, 3 sin, 4 sx, 5 sy, 6 opacity, 7..9 rgb
//   conic:   0 mean_x, 1 mean_y, 2 A, 3 B, 4 C, 6 opacity, 7..9 rgb
// Ellipse mode evaluates integer pixel coordinates with no clamp, skip or
// stop; conic mode puts pixel centres at +0.5 and gates and stops as below.
//
// Design. One block of 256 threads per tile (cameras are folded into the
// tile axis by the caller); each thread owns up to 4 pixels, strided by
// the block size so stores coalesce. The block walks its segment in chunks
// of G rows staged cooperatively in shared memory (16-byte loads, one
// chunk = G * 64 bytes), and every thread reads each row as a broadcast.
// Within a chunk the transmittance follows the chunked form of the
// reference, T = T_in * prod_{k<i}(1 - a_k), with per-chunk partial sums
// added to the accumulators, so the kernel rounds in the same order as its
// plain PyTorch version. Conic mode gates each contribution by
// T * (1 - a) >= 1e-4 and stops after a chunk once no pixel of the tile has
// T >= 1e-4 (__syncthreads_or), as the reference's early stop does.
//
// What bounds it. Each instance row is read from device memory once
// (64 bytes) and then evaluated on every pixel of its tile. Per (instance,
// pixel) pair the function needs at least 20 float32 operations, an expf
// counted as one: dx, dy (2); the quadratic form in dx, dy with per-row
// coefficients (7); expf and the opacity (2); contrib = a * T (1); the
// rgb and alpha sums (7); T -= contrib (1). The loop below does 27 in
// ellipse mode (the rotation, two divisions and the chunked T = t_in * cp)
// and 25 plus four comparisons in conic mode. Against 64 / 1024 bytes a
// pair, the kernel is bound by float32 throughput, not by memory. The
// design keeps every operand of the inner loop in registers or in a
// shared-memory broadcast and writes each output once.

#include <cuda_runtime.h>

namespace {

constexpr int kFeat = 16;
constexpr int kThreads = 256;
constexpr int kPixPerThread = 4;  // P <= 1024
constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaSkip = 0.003921569f;  // float32(1 / 255)
constexpr float kStopT = 1e-4f;

template <bool kConic>
__global__ void __launch_bounds__(kThreads)
composite_fwd_kernel(const float* __restrict__ inst, long long n_rows,
                     const int* __restrict__ astarts,
                     const int* __restrict__ counts,
                     const int* __restrict__ origins,
                     float* __restrict__ rgb, float* __restrict__ alpha,
                     int* __restrict__ jstop, float* __restrict__ tbounds,
                     int tw, int P, int G) {
  constexpr float kPixelOffset = kConic ? 0.5f : 0.0f;
  extern __shared__ float4 chunk4[];  // G rows x 16 floats
  const float* chunk = reinterpret_cast<const float*>(chunk4);

  const int t = blockIdx.x;
  const long long start = astarts[t];
  long long count = counts[t];
  if (start < 0 || start >= n_rows || count < 0) {
    count = 0;
  } else if (start + count > n_rows) {
    count = n_rows - start;  // never read past the instance array
  }
  const int n_steps = static_cast<int>((count + G - 1) / G);
  const float y0 = static_cast<float>(origins[2 * t]);
  const float x0 = static_cast<float>(origins[2 * t + 1]);

  float xs[kPixPerThread], ys[kPixPerThread], t_in[kPixPerThread];
  float acc_r[kPixPerThread], acc_g[kPixPerThread], acc_b[kPixPerThread],
      acc_a[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    xs[k] = x0 + static_cast<float>(p % tw) + kPixelOffset;
    ys[k] = y0 + static_cast<float>(p / tw) + kPixelOffset;
    t_in[k] = 1.0f;
    acc_r[k] = acc_g[k] = acc_b[k] = acc_a[k] = 0.0f;
  }

  int j = 0;
  for (; j < n_steps; ++j) {
    const long long row0 = start + static_cast<long long>(j) * G;
    const int nrows = static_cast<int>(min(static_cast<long long>(G),
                                           count - static_cast<long long>(j) * G));
    if (tbounds != nullptr) {
      float* tb = tbounds + (row0 / G) * P;
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        const int p = threadIdx.x + k * kThreads;
        if (p < P) tb[p] = t_in[k];
      }
    }
    __syncthreads();  // the previous chunk has been consumed
    const float4* src = reinterpret_cast<const float4*>(inst + row0 * kFeat);
    for (int i = threadIdx.x; i < nrows * (kFeat / 4); i += kThreads) {
      chunk4[i] = src[i];
    }
    __syncthreads();

    float cp[kPixPerThread], sr[kPixPerThread], sg[kPixPerThread],
        sb[kPixPerThread], sa[kPixPerThread];
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) {
      cp[k] = 1.0f;
      sr[k] = sg[k] = sb[k] = sa[k] = 0.0f;
    }

    for (int r = 0; r < nrows; ++r) {
      const float* f = chunk + r * kFeat;
      const float mx = f[0], my = f[1], op = f[6];
      const float cr = f[7], cg = f[8], cb = f[9];
      float c2, c3, c4, c5;
      if (kConic) {
        c2 = f[2];  // A
        c3 = f[3];  // B
        c4 = f[4];  // C
        c5 = 0.0f;
      } else {
        c2 = f[2];  // cos
        c3 = f[3];  // sin
        c4 = 2.0f * f[4] * f[4] + 1e-8f;  // 2 sx^2 + 1e-8
        c5 = 2.0f * f[5] * f[5] + 1e-8f;  // 2 sy^2 + 1e-8
      }
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        const int p = threadIdx.x + k * kThreads;
        if (p < P) {
          const float dx = xs[k] - mx;
          const float dy = ys[k] - my;
          float a;
          if (kConic) {
            const float sigma = 0.5f * (c2 * dx * dx + c4 * dy * dy) + c3 * dx * dy;
            const float raw = op * expf(-sigma);
            a = (sigma >= 0.0f && raw >= kAlphaSkip) ? fminf(kAlphaClamp, raw) : 0.0f;
          } else {
            const float u = c2 * dx + c3 * dy;
            const float v = -c3 * dx + c2 * dy;
            a = op * expf(-(u * u / c4 + v * v / c5));
          }
          const float T = t_in[k] * cp[k];
          const float one_minus = 1.0f - a;
          float contrib = a * T;
          if (kConic && !(T * one_minus >= kStopT)) contrib = 0.0f;
          sr[k] += contrib * cr;
          sg[k] += contrib * cg;
          sb[k] += contrib * cb;
          sa[k] += contrib;
          cp[k] *= one_minus;
        }
      }
    }

    bool live = false;
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) {
      acc_r[k] += sr[k];
      acc_g[k] += sg[k];
      acc_b[k] += sb[k];
      acc_a[k] += sa[k];
      t_in[k] *= cp[k];
      const int p = threadIdx.x + k * kThreads;
      live = live || (p < P && t_in[k] >= kStopT);
    }
    if (kConic && !__syncthreads_or(live)) {
      ++j;  // this chunk was walked
      break;
    }
  }

#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    if (p < P) {
      const long long base = static_cast<long long>(t) * 3 * P + p;
      rgb[base] = acc_r[k];
      rgb[base + P] = acc_g[k];
      rgb[base + 2 * P] = acc_b[k];
      alpha[static_cast<long long>(t) * P + p] = acc_a[k];
    }
  }
  if (threadIdx.x == 0) jstop[t] = j;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `tbounds` may be null (no store).
extern "C" int composite_fwd(const float* inst, long long n_rows,
                             const int* astarts, const int* counts,
                             const int* origins, float* rgb, float* alpha,
                             int* jstop, float* tbounds, int n_tiles, int th,
                             int tw, int G, int conic, void* stream) {
  const int P = th * tw;
  if (n_tiles < 0 || th <= 0 || tw <= 0 || P > kThreads * kPixPerThread ||
      G <= 0 || static_cast<size_t>(G) * kFeat * sizeof(float) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return 0;
  const size_t smem = static_cast<size_t>(G) * kFeat * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (conic) {
    composite_fwd_kernel<true><<<n_tiles, kThreads, smem, s>>>(
        inst, n_rows, astarts, counts, origins, rgb, alpha, jstop, tbounds, tw,
        P, G);
  } else {
    composite_fwd_kernel<false><<<n_tiles, kThreads, smem, s>>>(
        inst, n_rows, astarts, counts, origins, rgb, alpha, jstop, tbounds, tw,
        P, G);
  }
  return static_cast<int>(cudaGetLastError());
}
