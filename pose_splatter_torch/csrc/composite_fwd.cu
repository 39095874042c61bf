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
// counts[t]); astarts are multiples of G, non-empty segments are disjoint,
// and the phases use the rows of each segment that lie in the array (phase
// 0 cuts them to the array). `origins[t]` = (y0, x0). The chunk map
// (phase 0, csrc/composite_common.cuh) gives, for each chunk c of G rows (rows
// [c G, c G + G)), the tile whose segment holds it (`chunk_tile[c]`) and
// its index j in that segment (`chunk_j[c]`), or -1 for a padding chunk,
// in scratch that the wrapper allocates. Outputs: rgb [T, 3, P],
// alpha [T, P], jstop [T] (chunks of G rows walked), P = th * tw.
// Optional tbounds [n_rows / G, P]: row c holds chunk c's entry T of
// every pixel, for the walked chunks; other rows are left as they are. A
// null pointer skips the store (the eval path).
//   ellipse: 0 mean_x, 1 mean_y, 2 cos, 3 sin, 4 sx, 5 sy, 6 opacity, 7..9 rgb
//   conic:   0 mean_x, 1 mean_y, 2 A, 3 B, 4 C, 6 opacity, 7..9 rgb
// Ellipse mode evaluates integer pixel coordinates with no clamp, skip or
// stop; conic mode puts pixel centres at +0.5 and gates and stops as below.
//
// Design. The transmittance chain does not depend on the conic gate: T is
// multiplied by (1 - a) whether or not the gate keeps a contribution. So
// the entry T of chunk j of a tile is T_in[j + 1] = T_in[j] * cp[j], with
// cp[j] the product of (1 - a) over chunk j's rows, and the chunks of one
// tile can run in different blocks with T carried between them exactly.
// Busy tiles are few (14 of 96 in a 3D train step) and their segments long
// (up to some 200 chunks), so the parallel axis is the chunks of the
// instance array, R / G of them, a number the host knows without reading
// anything back. A memset and five launches on the caller's stream:
//   0. build_chunk_map, one block a tile (csrc/composite_common.cuh): the chunk
//      map and each segment's rows. Reads astarts, counts; writes map.
//   1. fwd_products, one block a chunk (padding chunks exit at once):
//      stages the chunk's rows in shared memory and writes cp[c][p], the
//      product of (1 - a) over the rows in row order.
//      Reads the rows; writes cp [R / G, P].
//   2. fwd_scan, one block a tile: T_in[0] = 1, T_in[j + 1] = T_in[j] *
//      cp[j] in chunk order, storing each walked chunk's T_in in tbounds
//      (train path) or over its cp row in place (eval path). Conic mode
//      stops after the first chunk after which no pixel of the tile has
//      T >= 1e-4 (__syncthreads_or), as the reference's early stop does,
//      and every mode writes jstop. Reads cp; writes T_in, jstop.
//   3. fwd_contrib, one block a walked chunk (j < jstop): recomputes a,
//      T = T_in * prod_{k<i}(1 - a_k) and the gate T * (1 - a) >= 1e-4
//      (conic), and writes the chunk's sums of contrib * rgb and contrib.
//      Reads the rows and T_in; writes part [R / G, 4, P].
//   4. fwd_sum, blocks of 256 (component, pixel) pairs of a tile: adds the
//      walked chunks' partial sums in chunk order from 0.
// Every expression and every order of operations is the single walk's of
// the one-block-a-tile kernel this replaces (built with -fmad=false and the
// accurate expf), so rgb, alpha, jstop and tbounds are bit-equal to it, the
// early stop and the gates take the same branches, and reruns are
// bit-identical. The price: in conic mode phase 1 also evaluates the
// chunks of a segment past its stop, which the single walk never touched.
// Each thread owns up to 4 pixels, strided by the block size so stores
// coalesce; every thread reads each staged row as a shared-memory
// broadcast.
//
// What bounds it. Each instance row is read from device memory once
// (64 bytes) and then evaluated on every pixel of its tile. Per (instance,
// pixel) pair the function needs at least 20 float32 operations, an expf
// counted as one: dx, dy (2); the quadratic form in dx, dy with per-row
// coefficients (7); expf and the opacity (2); contrib = a * T (1); the
// rgb and alpha sums (7); T -= contrib (1). Phases 1 and 3 together do
// about 40 in ellipse mode (the rotation, two divisions and a and (1 - a)
// twice) and 36 plus comparisons in conic mode. Against 64 / 1024 bytes a
// pair, the kernel is bound by float32 throughput, not by memory; the
// scratch rows (4 P bytes a chunk for cp and T_in, 16 P for the partial
// sums) are written and read once each. Phases 1 and 3 ask for 4 resident
// blocks (32 warps) an SM so that the latency of one block's sequential
// (1 - a) products and accurate expf hides behind the others'. Each block
// stages one chunk of rows, so there is no next chunk to prefetch inside a
// block: the other resident blocks overlap their loads with its compute.
// The scans load kAhead chunks' rows before they multiply, so their
// sequential walk waits on memory once every kAhead chunks.
//
// Tensor cores are not used. The per-pair work is an expf, the gates and a
// 6-term quadratic form in float32. The port holds the kernel to its plain
// version within 1e-5 and the conic gates flip on rounding; a TF32 product
// of the quadratic form (10 bits of mantissa) would break both.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

constexpr int kMinBlocks = 4;  // resident blocks an SM, phases 1 and 3

template <bool kConic>
__device__ __forceinline__ float alpha_at(const Row& r, float x, float y) {
  const float dx = x - r.mx;
  const float dy = y - r.my;
  if (kConic) {
    const float sigma = 0.5f * (r.c2 * dx * dx + r.c4 * dy * dy) + r.c3 * dx * dy;
    const float raw = r.op * expf(-sigma);
    return (sigma >= 0.0f && raw >= kAlphaSkip) ? fminf(kAlphaClamp, raw) : 0.0f;
  }
  const float u = r.c2 * dx + r.c3 * dy;
  const float v = -r.c3 * dx + r.c2 * dy;
  return r.op * expf(-(u * u / r.c4 + v * v / r.c5));
}

// Phase 1: cp[c][p] = prod over chunk c's rows of (1 - a).
template <bool kConic>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fwd_products(const float* __restrict__ inst, const int* __restrict__ counts,
             const int* __restrict__ origins,
             const int* __restrict__ chunk_tile,
             const int* __restrict__ chunk_j, float* __restrict__ cp_out,
             int tw, int P, int G) {
  extern __shared__ float4 chunk4[];  // G rows x 16 floats
  const float* chunk = reinterpret_cast<const float*>(chunk4);
  const long long c = blockIdx.x;
  const int t = chunk_tile[c];
  if (t < 0) return;  // padding
  const int nrows = min(G, counts[t] - chunk_j[c] * G);
  stage_rows(chunk4, inst, c, G, nrows);

  float xs[kPixPerThread], ys[kPixPerThread], cp[kPixPerThread];
  pixel_coords<kConic>(origins, t, tw, xs, ys);
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) cp[k] = 1.0f;
  for (int r = 0; r < nrows; ++r) {
    const Row row = load_row<kConic>(chunk + r * kFeat);
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) {
      if (threadIdx.x + k * kThreads < P) {
        const float one_minus = 1.0f - alpha_at<kConic>(row, xs[k], ys[k]);
        cp[k] *= one_minus;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    if (p < P) cp_out[c * P + p] = cp[k];
  }
}

// Phase 2: each tile's entry T of every chunk, in chunk order, and jstop.
// `tin` may be `cp` itself: each thread reads a row's pixels before it
// writes them, so neither pointer is restrict.
template <bool kConic>
__global__ void __launch_bounds__(kThreads)
fwd_scan(const float* cp, float* tin, const int* __restrict__ astarts,
         const int* __restrict__ counts, int* __restrict__ jstop, int P,
         int G) {
  const int t = blockIdx.x;
  const int n = (counts[t] + G - 1) / G;
  const long long c0 = n > 0 ? astarts[t] / G : 0;
  float t_in[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) t_in[k] = 1.0f;

  int walked = n;
  for (int j0 = 0; j0 < n && walked == n; j0 += kAhead) {
    float ahead[kAhead][kPixPerThread];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        const int p = threadIdx.x + k * kThreads;
        ahead[a][k] = (j0 + a < n && p < P) ? cp[(c0 + j0 + a) * P + p] : 1.0f;
      }
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      if (j0 + a >= n) break;  // uniform over the block
      float* row = tin + (c0 + j0 + a) * P;
      bool live = false;
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        const int p = threadIdx.x + k * kThreads;
        if (p < P) row[p] = t_in[k];
        t_in[k] *= ahead[a][k];
        live = live || (p < P && t_in[k] >= kStopT);
      }
      if (kConic && !__syncthreads_or(live)) {
        walked = j0 + a + 1;  // this chunk was walked
        break;
      }
    }
  }
  if (threadIdx.x == 0) jstop[t] = walked;
}

// Phase 3: each walked chunk's sums of contrib * rgb and of contrib.
template <bool kConic>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fwd_contrib(const float* __restrict__ inst, const int* __restrict__ counts,
            const int* __restrict__ origins,
            const int* __restrict__ chunk_tile,
            const int* __restrict__ chunk_j, const int* __restrict__ jstop,
            const float* __restrict__ tin, float* __restrict__ part, int tw,
            int P, int G) {
  extern __shared__ float4 chunk4[];  // G rows x 16 floats
  const float* chunk = reinterpret_cast<const float*>(chunk4);
  const long long c = blockIdx.x;
  const int t = chunk_tile[c];
  if (t < 0) return;  // padding
  const int j = chunk_j[c];
  if (j >= jstop[t]) return;  // past the tile's stop
  const int nrows = min(G, counts[t] - j * G);
  stage_rows(chunk4, inst, c, G, nrows);

  float xs[kPixPerThread], ys[kPixPerThread], t_in[kPixPerThread];
  float cp[kPixPerThread], sr[kPixPerThread], sg[kPixPerThread],
      sb[kPixPerThread], sa[kPixPerThread];
  pixel_coords<kConic>(origins, t, tw, xs, ys);
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    t_in[k] = p < P ? tin[c * P + p] : 0.0f;
    cp[k] = 1.0f;
    sr[k] = sg[k] = sb[k] = sa[k] = 0.0f;
  }
  for (int r = 0; r < nrows; ++r) {
    const Row row = load_row<kConic>(chunk + r * kFeat);
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) {
      if (threadIdx.x + k * kThreads < P) {
        const float a = alpha_at<kConic>(row, xs[k], ys[k]);
        const float T = t_in[k] * cp[k];
        const float one_minus = 1.0f - a;
        float contrib = a * T;
        if (kConic && !(T * one_minus >= kStopT)) contrib = 0.0f;
        sr[k] += contrib * row.cr;
        sg[k] += contrib * row.cg;
        sb[k] += contrib * row.cb;
        sa[k] += contrib;
        cp[k] *= one_minus;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    if (p < P) {
      float* dst = part + c * 4 * P + p;
      dst[0] = sr[k];
      dst[P] = sg[k];
      dst[2 * P] = sb[k];
      dst[3 * P] = sa[k];
    }
  }
}

// Phase 4: rgb and alpha, the walked chunks' partial sums added in chunk
// order. Thread q of a tile's blocks owns component q / P of pixel q % P.
__global__ void __launch_bounds__(kThreads)
fwd_sum(const float* __restrict__ part, const int* __restrict__ astarts,
        const int* __restrict__ jstop, float* __restrict__ rgb,
        float* __restrict__ alpha, int P, int G, int blocks_per_tile) {
  const int t = blockIdx.x / blocks_per_tile;
  const int q = (blockIdx.x - t * blocks_per_tile) * kThreads + threadIdx.x;
  if (q >= 4 * P) return;
  const int comp = q / P;  // 0..2 rgb, 3 alpha
  const int p = q - comp * P;
  const int n = jstop[t];
  const long long c0 = n > 0 ? astarts[t] / G : 0;
  const long long stride = 4LL * P;
  const float* src = part + (c0 * 4 + comp) * P + p;
  float acc = 0.0f;
  for (int j0 = 0; j0 < n; j0 += kAhead) {
    float v[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      v[a] = j0 + a < n ? src[(j0 + a) * stride] : 0.0f;
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      if (j0 + a < n) acc += v[a];
    }
  }
  if (comp < 3) {
    rgb[(static_cast<long long>(t) * 3 + comp) * P + p] = acc;
  } else {
    alpha[static_cast<long long>(t) * P + p] = acc;
  }
}

template <bool kConic>
int launch(const float* inst, long long n_rows, const int* astarts,
           const int* counts, const int* origins, int* map, float* rgb,
           float* alpha, int* jstop, float* tbounds, float* cp, float* part,
           int n_tiles, int tw, int P, int G, cudaStream_t s) {
  const long long n_chunks = n_rows / G;
  const int* chunk_tile = map;
  const int* chunk_j = map + n_chunks;
  const int* rows = map + 2 * n_chunks;  // counts, cut to the array
  const size_t smem = static_cast<size_t>(G) * kFeat * sizeof(float);
  float* tin = tbounds != nullptr ? tbounds : cp;
  cudaError_t err =
      launch_chunk_map(astarts, counts, n_rows, G, n_tiles, map, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_chunks > 0) {
    fwd_products<kConic><<<n_chunks, kThreads, smem, s>>>(
        inst, rows, origins, chunk_tile, chunk_j, cp, tw, P, G);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  fwd_scan<kConic><<<n_tiles, kThreads, 0, s>>>(cp, tin, astarts, rows, jstop,
                                                P, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (n_chunks > 0) {
    fwd_contrib<kConic><<<n_chunks, kThreads, smem, s>>>(
        inst, rows, origins, chunk_tile, chunk_j, jstop, tin, part, tw, P, G);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks_per_tile = (4 * P + kThreads - 1) / kThreads;
  fwd_sum<<<n_tiles * blocks_per_tile, kThreads, 0, s>>>(
      part, astarts, jstop, rgb, alpha, P, G, blocks_per_tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the phases on `stream` in turn and returns the first
// cudaGetLastError() that is not 0 (0 on success). `tbounds` may be null
// (no store). Scratch that the caller allocates: `map` (2 * n_rows / G +
// n_tiles int32: the chunk map and each segment's rows), `cp` [n_rows / G,
// P] and `part` [n_rows / G, 4, P].
extern "C" int composite_fwd(const float* inst, long long n_rows,
                             const int* astarts, const int* counts,
                             const int* origins, int* map, float* rgb,
                             float* alpha, int* jstop, float* tbounds,
                             float* cp, float* part, int n_tiles, int th,
                             int tw, int G, int conic, void* stream) {
  const int P = th * tw;
  if (n_tiles < 0 || th <= 0 || tw <= 0 || P > kThreads * kPixPerThread ||
      G <= 0 || n_rows % G != 0 ||
      static_cast<size_t>(G) * kFeat * sizeof(float) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (conic) {
    return launch<true>(inst, n_rows, astarts, counts, origins, map, rgb,
                        alpha, jstop, tbounds, cp, part, n_tiles, tw, P, G, s);
  }
  return launch<false>(inst, n_rows, astarts, counts, origins, map, rgb, alpha,
                       jstop, tbounds, cp, part, n_tiles, tw, P, G, s);
}
