// Backward compositor over per-tile instance segments, for sm_90a.
//
// Replaces the TPU kernel `_bwd_kernel` (with its wrapper `_backward_call`
// and the custom VJP `_make_compositor`) in
// pose_splatter_tpu/ops/rasterize_pallas.py: given the loss gradient of
// every pixel's rgb and alpha, it writes each instance row's gradient with
// respect to its packed features, from the entry transmittance of each
// chunk that the forward stored (`tbounds`, csrc/composite_fwd.cu), with
// no division to rebuild T.
//
// Math (per pixel, instance i of a tile, in compositing order):
//   contrib_i = a_i T_i keep_i,  w_i = <g_rgb, rgb_i> + g_alpha,
//   S_i = sum_{k>i} w_k contrib_k (the suffix),
//   dL/da_i = w_i T_i keep_i - S_i / (1 - a_i),
// then the chain through the alpha of each mode (rasterize_pallas.py:
// 595-651): ellipse rows get d(mean_x, mean_y, cos, sin, sx, sy, opacity,
// rgb) in columns 0..9; conic rows d(mean_x, mean_y, A, B, C, -, opacity,
// rgb), gated by `flow` (the alpha was neither skipped nor clamped), with
// column 5 zero. Columns 10..15 stay zero.
//
// Layout. As the forward: inst [n_rows, 16] f32, tile t owns rows
// [astarts[t], astarts[t] + counts[t]) (astarts multiples of G, non-empty
// segments disjoint), the chunk map chunk_tile / chunk_j [n_rows / G] and
// each segment's rows in the array (phase 0, csrc/composite_common.cuh, in
// scratch that the wrapper allocates); origins [T, 2] (y0, x0);
// jstop [T] chunks the forward walked; tbounds [n_rows / G, P]; g_rgb
// [T, 3, P]; g_alpha [T, P]. Output dinst [n_rows, 16], zeroed by the
// caller: only walked rows are written, so unwalked chunks and padding rows
// keep their zeros (the TPU wrapper aliases a zero input for the same
// reason).
//
// Design. Chunk j of a tile needs, besides its own rows and entry T, only
// the suffix carried in from the chunks after it: sfx[j] = sum_{k>j}
// tot[k], with tot[k] = sum over chunk k's rows of w * contrib. That is a
// per-pixel sum over per-chunk totals, so the chunks of one tile can run in
// different blocks. A memset and four launches on the caller's stream:
//   0. build_chunk_map, one block a tile (csrc/composite_common.cuh), as in the
//      forward.
//   1. bwd_tot, one block a walked chunk (padding chunks and chunks at or
//      past jstop exit at once): recomputes a, T, keep and contrib from the
//      stored entry T and writes tot[c][p]. Reads the rows, tbounds and
//      the pixel gradients; writes tot [R / G, P].
//   2. bwd_scan, blocks of 256 pixels of a tile: sfx[j] = sum of tot[k]
//      over k = jstop - 1 ... j + 1, added in that order from 0.
//      Reads tot; writes sfx [R / G, P].
//   3. bwd_grad, one block a walked chunk: walks the rows forwards again
//      with the running inclusive sum incl_i, forms S_i = sfx + (tot -
//      incl_i), then each row's gradient terms, and writes the chunk's rows.
//      Reads the rows, tbounds, tot, sfx and the pixel gradients; writes
//      dinst.
// Every expression and every order of operations is the one-block-a-tile
// walk's that this replaces: T is recomputed exactly as the forward forms
// it (T = t_in * cp, cp multiplied sequentially, the same expression for
// a; built with -fmad=false and the accurate expf), so the conic gate
// T (1 - a) >= 1e-4 takes the same branch as in the forward on every
// pixel, tot and the suffix are added in the same order, and dinst is
// bit-equal to that kernel's.
//
// Each row's 10 gradients are sums over the tile's P pixels. Each thread
// owns up to 4 pixels, strided by the block size; it adds its own pixels, a
// warp-shuffle tree reduces the warp, lane 0 writes the warp's partial to
// shared memory, and after the chunk each (row, column) adds the 8 warp
// partials in a fixed order and writes the row once. No atomics: each row
// belongs to one chunk, so the result is deterministic from run to run.
//
// What bounds it. Each walked row is read once (64 bytes) and written once,
// each walked chunk's tbounds row once (4 P bytes), and the pixel gradients
// once (16 P bytes a tile); against that, at least 49 float32 operations a
// (instance, pixel) pair (derived in benchmark/counts.py). With P = 1024 pixels a
// row the kernel is bound by float32 throughput, not by memory; the tot
// and sfx scratch rows (4 P bytes a chunk each) are written once and read
// once or twice. Phases 1 and 3 recompute a and T (about 13 operations a
// pair each) instead of storing a [G, P] chunk of per-pair values; the
// per-row reduction costs 5 shuffle rounds for each of the 10 gradients.
// Phase 1 asks for 4 resident blocks (32 warps) an SM, so that one block's
// sequential products and expf latency hide behind the others'. Phase 3
// keeps 11 values a pixel of its 4 pixels and 10 sums live through its row
// loop: at 3 blocks an SM (80 registers) ptxas spills 12-20 bytes a
// thread, so it asks for 2 (16 warps, 93-96 registers, no spill).
// Each block stages one chunk of rows, so there is no next chunk to
// prefetch inside a block; the scan loads kAhead chunks before it adds.
//
// Tensor cores are not used: the per-pair work is an expf, the gates and a
// 6-term quadratic form in float32. The port holds the kernel to its plain
// version at float32 rounding and the conic gates flip on rounding; TF32
// products (10 bits of mantissa) would break both.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kGrad = 10;          // gradient columns 0..9
constexpr int kMinBlocksTot = 4;   // resident blocks an SM, phase 1
constexpr int kMinBlocksGrad = 2;  // resident blocks an SM, phase 3

// One (instance, pixel) pair: alpha and what its gradient needs.
struct Pair {
  float dx, dy, a, e, u, v, raw;
  bool flow;  // conic: the gradient passes the skip and the clamp
};

template <bool kConic>
__device__ __forceinline__ Pair eval_pair(const Row& r, float x, float y) {
  Pair q;
  q.dx = x - r.mx;
  q.dy = y - r.my;
  if (kConic) {
    const float sigma =
        0.5f * (r.c2 * q.dx * q.dx + r.c4 * q.dy * q.dy) + r.c3 * q.dx * q.dy;
    q.e = expf(-sigma);
    q.raw = r.op * q.e;
    const bool live = sigma >= 0.0f && q.raw >= kAlphaSkip;
    q.a = live ? fminf(kAlphaClamp, q.raw) : 0.0f;
    q.flow = live && q.raw < kAlphaClamp;
    q.u = q.v = 0.0f;
  } else {
    q.u = r.c2 * q.dx + r.c3 * q.dy;
    q.v = -r.c3 * q.dx + r.c2 * q.dy;
    q.e = expf(-(q.u * q.u / r.c4 + q.v * q.v / r.c5));
    q.a = r.op * q.e;
    q.raw = q.a;
    q.flow = true;
  }
  return q;
}

// The walked chunk that block `c` handles: its tile and row count, or
// t = -1 when the chunk is padding or at or past its tile's jstop.
struct Chunk {
  int t, nrows;
};

__device__ __forceinline__ Chunk walked_chunk(long long c,
                                              const int* chunk_tile,
                                              const int* chunk_j,
                                              const int* counts,
                                              const int* jstop, int G) {
  Chunk k{chunk_tile[c], 0};
  if (k.t < 0) return k;
  const int j = chunk_j[c];
  const int n_steps = (counts[k.t] + G - 1) / G;
  if (j >= min(jstop[k.t], n_steps)) {
    k.t = -1;
    return k;
  }
  k.nrows = min(G, counts[k.t] - j * G);
  return k;
}

// What every thread needs of tile t's pixels: coordinates and the loss
// gradients, and chunk c's entry T.
template <bool kConic>
__device__ __forceinline__ void load_pixels(
    const int* origins, const float* g_rgb, const float* g_alpha,
    const float* tbounds, int t, long long c, int tw, int P, float* xs,
    float* ys, float* gr, float* gg, float* gb, float* ga, float* t_in) {
  pixel_coords<kConic>(origins, t, tw, xs, ys);
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    const bool in = p < P;
    const long long base = static_cast<long long>(t) * 3 * P + p;
    gr[k] = in ? g_rgb[base] : 0.0f;
    gg[k] = in ? g_rgb[base + P] : 0.0f;
    gb[k] = in ? g_rgb[base + 2 * P] : 0.0f;
    ga[k] = in ? g_alpha[static_cast<long long>(t) * P + p] : 0.0f;
    t_in[k] = in ? tbounds[c * P + p] : 0.0f;
  }
}

// Phase 1: tot[c][p] = sum_i w_i contrib_i over chunk c's rows.
template <bool kConic>
__global__ void __launch_bounds__(kThreads, kMinBlocksTot)
bwd_tot(const float* __restrict__ inst, const float* __restrict__ tbounds,
        const int* __restrict__ counts, const int* __restrict__ origins,
        const int* __restrict__ jstop, const float* __restrict__ g_rgb,
        const float* __restrict__ g_alpha,
        const int* __restrict__ chunk_tile, const int* __restrict__ chunk_j,
        float* __restrict__ tot_out, int tw, int P, int G) {
  extern __shared__ float4 chunk4[];  // G rows x 16 floats
  const float* chunk = reinterpret_cast<const float*>(chunk4);
  const long long c = blockIdx.x;
  const Chunk ck = walked_chunk(c, chunk_tile, chunk_j, counts, jstop, G);
  if (ck.t < 0) return;
  stage_rows(chunk4, inst, c, G, ck.nrows);

  float xs[kPixPerThread], ys[kPixPerThread], t_in[kPixPerThread];
  float gr[kPixPerThread], gg[kPixPerThread], gb[kPixPerThread],
      ga[kPixPerThread];
  load_pixels<kConic>(origins, g_rgb, g_alpha, tbounds, ck.t, c, tw, P, xs,
                      ys, gr, gg, gb, ga, t_in);
  float cp[kPixPerThread], tot[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    cp[k] = 1.0f;
    tot[k] = 0.0f;
  }
  for (int r = 0; r < ck.nrows; ++r) {
    const Row row = load_row<kConic>(chunk + r * kFeat);
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) {
      if (threadIdx.x + k * kThreads < P) {
        const Pair q = eval_pair<kConic>(row, xs[k], ys[k]);
        const float T = t_in[k] * cp[k];
        const float one_minus = 1.0f - q.a;
        const bool keep = !kConic || T * one_minus >= kStopT;
        const float contrib = keep ? q.a * T : 0.0f;
        const float w = gr[k] * row.cr + gg[k] * row.cg + gb[k] * row.cb + ga[k];
        tot[k] += w * contrib;
        cp[k] *= one_minus;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    if (p < P) tot_out[c * P + p] = tot[k];
  }
}

// Phase 2: the suffix each walked chunk carries in, sfx[j] = sum of tot[k]
// over k = walked - 1 ... j + 1. Thread q of a tile's blocks owns pixel q.
__global__ void __launch_bounds__(kThreads)
bwd_scan(const float* __restrict__ tot, float* __restrict__ sfx,
         const int* __restrict__ astarts, const int* __restrict__ counts,
         const int* __restrict__ jstop, int P, int G, int blocks_per_tile) {
  const int t = blockIdx.x / blocks_per_tile;
  const int p = (blockIdx.x - t * blocks_per_tile) * kThreads + threadIdx.x;
  if (p >= P) return;
  const int n_steps = (counts[t] + G - 1) / G;
  const int walked = max(0, min(jstop[t], n_steps));
  const long long c0 = walked > 0 ? astarts[t] / G : 0;
  float s = 0.0f;
  for (int j0 = walked - 1; j0 >= 0; j0 -= kAhead) {
    float v[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      v[a] = j0 - a >= 0 ? tot[(c0 + j0 - a) * P + p] : 0.0f;
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      if (j0 - a >= 0) {
        sfx[(c0 + j0 - a) * P + p] = s;
        s += v[a];
      }
    }
  }
}

// Phase 3: each walked row's gradient, reduced over the tile's pixels.
template <bool kConic>
__global__ void __launch_bounds__(kThreads, kMinBlocksGrad)
bwd_grad(const float* __restrict__ inst, const float* __restrict__ tbounds,
         const int* __restrict__ counts, const int* __restrict__ origins,
         const int* __restrict__ jstop, const float* __restrict__ g_rgb,
         const float* __restrict__ g_alpha,
         const int* __restrict__ chunk_tile, const int* __restrict__ chunk_j,
         const float* __restrict__ tot_in, const float* __restrict__ sfx_in,
         float* __restrict__ dinst, int tw, int P, int G) {
  extern __shared__ float4 smem4[];
  float* chunk = reinterpret_cast<float*>(smem4);  // G rows x 16 floats
  float* partial = chunk + G * kFeat;              // [kWarps][G][kGrad]
  const long long c = blockIdx.x;
  const Chunk ck = walked_chunk(c, chunk_tile, chunk_j, counts, jstop, G);
  if (ck.t < 0) return;
  stage_rows(smem4, inst, c, G, ck.nrows);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float xs[kPixPerThread], ys[kPixPerThread], t_in[kPixPerThread];
  float gr[kPixPerThread], gg[kPixPerThread], gb[kPixPerThread],
      ga[kPixPerThread];
  load_pixels<kConic>(origins, g_rgb, g_alpha, tbounds, ck.t, c, tw, P, xs,
                      ys, gr, gg, gb, ga, t_in);
  float cp[kPixPerThread], incl[kPixPerThread], tot[kPixPerThread],
      sfx[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    cp[k] = 1.0f;
    incl[k] = 0.0f;
    tot[k] = p < P ? tot_in[c * P + p] : 0.0f;
    sfx[k] = p < P ? sfx_in[c * P + p] : 0.0f;
  }
  for (int r = 0; r < ck.nrows; ++r) {
    const Row row = load_row<kConic>(chunk + r * kFeat);
    float acc[kGrad];
#pragma unroll
    for (int g = 0; g < kGrad; ++g) acc[g] = 0.0f;
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) {
      if (threadIdx.x + k * kThreads < P) {
        const Pair q = eval_pair<kConic>(row, xs[k], ys[k]);
        const float T = t_in[k] * cp[k];
        const float one_minus = 1.0f - q.a;
        const bool keep = !kConic || T * one_minus >= kStopT;
        const float contrib = keep ? q.a * T : 0.0f;
        const float w = gr[k] * row.cr + gg[k] * row.cg + gb[k] * row.cb + ga[k];
        incl[k] += w * contrib;
        const float s = sfx[k] + (tot[k] - incl[k]);  // sum over later rows
        const float da = (keep ? w * T : 0.0f) - s / one_minus;
        cp[k] *= one_minus;
        acc[7] += gr[k] * contrib;
        acc[8] += gg[k] * contrib;
        acc[9] += gb[k] * contrib;
        if (kConic) {
          const float daf = q.flow ? da : 0.0f;
          const float dsigma = -q.raw * daf;
          acc[6] += q.e * daf;
          acc[2] += 0.5f * q.dx * q.dx * dsigma;
          acc[3] += q.dx * q.dy * dsigma;
          acc[4] += 0.5f * q.dy * q.dy * dsigma;
          acc[0] += -(row.c2 * q.dx + row.c3 * q.dy) * dsigma;
          acc[1] += -(row.c4 * q.dy + row.c3 * q.dx) * dsigma;
        } else {
          acc[6] += q.e * da;
          const float dE = row.op * da;
          const float du = dE * (q.e * (-2.0f * q.u / row.c4));
          const float dv = dE * (q.e * (-2.0f * q.v / row.c5));
          acc[2] += du * q.dx + dv * q.dy;                // cos
          acc[3] += du * q.dy - dv * q.dx;                // sin
          acc[0] += -(du * row.c2 - dv * row.c3);         // mean_x
          acc[1] += -(du * row.c3 + dv * row.c2);         // mean_y
          acc[4] += dE * q.e * (q.u * q.u / (row.c4 * row.c4));  // sx, / 4 sx
          acc[5] += dE * q.e * (q.v * q.v / (row.c5 * row.c5));  // sy, / 4 sy
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kGrad; ++g) {
      float v = acc[g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, off);
      }
      if (lane == 0) partial[(warp * G + r) * kGrad + g] = v;
    }
  }
  __syncthreads();

  // Fixed-order sum of the warp partials; each row written once.
  const long long row0 = c * G;
  for (int i = threadIdx.x; i < ck.nrows * kGrad; i += kThreads) {
    const int r = i / kGrad;
    const int g = i - r * kGrad;
    float v = 0.0f;
    for (int w = 0; w < kWarps; ++w) v += partial[(w * G + r) * kGrad + g];
    if (!kConic && (g == 4 || g == 5)) {
      v = v * 4.0f * chunk[r * kFeat + g];  // d(2 s^2 + 1e-8)/ds = 4 s
    }
    if (kConic && g == 5) v = 0.0f;
    dinst[(row0 + r) * kFeat + g] = v;
  }
}

template <bool kConic>
int launch(const float* inst, long long n_rows, const float* tbounds,
           const int* astarts, const int* counts, const int* origins,
           const int* jstop, const float* g_rgb, const float* g_alpha,
           int* map, float* dinst, float* tot, float* sfx, int n_tiles, int tw,
           int P, int G, size_t smem_rows, size_t smem_grad, cudaStream_t s) {
  const long long n_chunks = n_rows / G;
  if (n_chunks == 0) return 0;  // no rows, nothing walked
  const int* chunk_tile = map;
  const int* chunk_j = map + n_chunks;
  const int* rows = map + 2 * n_chunks;  // counts, cut to the array
  cudaError_t err =
      launch_chunk_map(astarts, counts, n_rows, G, n_tiles, map, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_tot<kConic><<<n_chunks, kThreads, smem_rows, s>>>(
      inst, tbounds, rows, origins, jstop, g_rgb, g_alpha, chunk_tile, chunk_j,
      tot, tw, P, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int blocks_per_tile = (P + kThreads - 1) / kThreads;
  bwd_scan<<<n_tiles * blocks_per_tile, kThreads, 0, s>>>(
      tot, sfx, astarts, rows, jstop, P, G, blocks_per_tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  cudaFuncSetAttribute(bwd_grad<kConic>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem_grad));
  bwd_grad<kConic><<<n_chunks, kThreads, smem_grad, s>>>(
      inst, tbounds, rows, origins, jstop, g_rgb, g_alpha, chunk_tile, chunk_j,
      tot, sfx, dinst, tw, P, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the phases on `stream` in turn and returns the first
// cudaGetLastError() that is not 0 (0 on success). Scratch that the caller
// allocates: `map` (2 * n_rows / G + n_tiles int32: the chunk map and each
// segment's rows), `tot` and `sfx` [n_rows / G, P].
extern "C" int composite_bwd(const float* inst, long long n_rows,
                             const float* tbounds, const int* astarts,
                             const int* counts, const int* origins,
                             const int* jstop, const float* g_rgb,
                             const float* g_alpha, int* map, float* dinst,
                             float* tot, float* sfx, int n_tiles, int th,
                             int tw, int G, int conic, void* stream) {
  const int P = th * tw;
  const size_t smem_rows = static_cast<size_t>(G) * kFeat * sizeof(float);
  const size_t smem_grad =
      smem_rows + static_cast<size_t>(kWarps) * G * kGrad * sizeof(float);
  if (n_tiles < 0 || th <= 0 || tw <= 0 || P > kThreads * kPixPerThread ||
      G <= 0 || n_rows % G != 0 || smem_rows > 48 * 1024 ||
      smem_grad > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (conic) {
    return launch<true>(inst, n_rows, tbounds, astarts, counts, origins, jstop,
                        g_rgb, g_alpha, map, dinst, tot, sfx, n_tiles, tw, P,
                        G, smem_rows, smem_grad, s);
  }
  return launch<false>(inst, n_rows, tbounds, astarts, counts, origins, jstop,
                       g_rgb, g_alpha, map, dinst, tot, sfx, n_tiles, tw, P, G,
                       smem_rows, smem_grad, s);
}
