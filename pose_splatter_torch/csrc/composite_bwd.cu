// Backward compositor over per-tile instance segments, for sm_90a.
//
// Replaces the TPU kernel `_bwd_kernel` (with its wrapper `_backward_call`
// and the custom VJP `_make_compositor`) in
// pose_splatter_tpu/ops/rasterize_pallas.py: given the loss gradient of
// every pixel's rgb and alpha, it writes each instance row's gradient with
// respect to its packed features, walking each tile's segment back to
// front from the entry transmittance that the forward stored (`tbounds`,
// csrc/composite_fwd.cu), with no division to rebuild T.
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
// [astarts[t], astarts[t] + counts[t]), astarts multiples of G; origins
// [T, 2] (y0, x0); jstop [T] chunks the forward walked; tbounds
// [n_rows / G, P]; g_rgb [T, 3, P]; g_alpha [T, P]. Output dinst
// [n_rows, 16], zeroed by the caller: only walked rows are written, so
// unwalked chunks and padding rows keep their zeros (the TPU wrapper
// aliases a zero input for the same reason).
//
// Design. One block of 256 threads per tile (cameras folded into the tile
// axis by the caller), each thread owning up to 4 pixels, as the forward.
// The block walks chunks j = jstop - 1 ... 0, each staged in shared memory.
// Within a chunk it walks the rows FORWARDS twice, as the TPU kernel's
// `incl` / `tot` form allows: pass 1 recomputes a, T, keep and contrib and
// sums tot = sum_i w_i contrib_i; pass 2 recomputes them again and forms
// S_i = sfx + (tot - incl_i) with the running inclusive sum incl_i, then
// each row's gradient terms. After the chunk, sfx += tot. T is recomputed
// exactly as the forward forms it (T = t_in * cp, cp multiplied
// sequentially, the same expression for a; built with -fmad=false and the
// accurate expf), so the conic gate T (1 - a) >= 1e-4 takes the same branch
// as in the forward on every pixel.
//
// Each row's 10 gradients are sums over the tile's P pixels. Every thread
// adds its own pixels, a warp-shuffle tree reduces the warp, lane 0 writes
// the warp's partial to shared memory, and after the chunk each (row,
// column) adds the 8 warp partials in a fixed order and writes the row
// once. No atomics: each row belongs to one tile, so the result is
// deterministic.
//
// What bounds it. Each walked row is read once (64 bytes) and written once,
// each walked chunk's tbounds row once (4 P bytes), and the pixel gradients
// once (16 P bytes a tile); against that, at least 49 float32 operations a
// (instance, pixel) pair (derived in chip_smoke.py). With P = 1024 pixels a
// row the kernel is bound by float32 throughput, not by memory. The design
// keeps every operand of the two inner loops in registers or a shared-memory
// broadcast; the price of the two passes is a second recompute of a and T
// (about 13 operations a pair) instead of storing a [G, P] chunk of
// per-pair values, and of the per-row reduction 5 shuffle rounds for each
// of the 10 gradients.

#include <cuda_runtime.h>

namespace {

constexpr int kFeat = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixPerThread = 4;  // P <= 1024
constexpr int kGrad = 10;         // gradient columns 0..9
constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaSkip = 0.003921569f;  // float32(1 / 255)
constexpr float kStopT = 1e-4f;

// Per-row coefficients, as the forward forms them.
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
  r.c2 = f[2];
  r.c3 = f[3];
  if (kConic) {
    r.c4 = f[4];
    r.c5 = 0.0f;
  } else {
    r.c4 = 2.0f * f[4] * f[4] + 1e-8f;  // 2 sx^2 + 1e-8
    r.c5 = 2.0f * f[5] * f[5] + 1e-8f;  // 2 sy^2 + 1e-8
  }
  return r;
}

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

template <bool kConic>
__global__ void __launch_bounds__(kThreads)
composite_bwd_kernel(const float* __restrict__ inst, long long n_rows,
                     const float* __restrict__ tbounds,
                     const int* __restrict__ astarts,
                     const int* __restrict__ counts,
                     const int* __restrict__ origins,
                     const int* __restrict__ jstop,
                     const float* __restrict__ g_rgb,
                     const float* __restrict__ g_alpha,
                     float* __restrict__ dinst, int tw, int P, int G) {
  constexpr float kPixelOffset = kConic ? 0.5f : 0.0f;
  extern __shared__ float4 smem4[];
  float* chunk = reinterpret_cast<float*>(smem4);  // G rows x 16 floats
  float* partial = chunk + G * kFeat;              // [kWarps][G][kGrad]

  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long start = astarts[t];
  long long count = counts[t];
  if (start < 0 || start >= n_rows || count < 0) {
    count = 0;
  } else if (start + count > n_rows) {
    count = n_rows - start;  // never read past the instance array
  }
  const int n_steps = static_cast<int>((count + G - 1) / G);
  const int walked = max(0, min(jstop[t], n_steps));
  const float y0 = static_cast<float>(origins[2 * t]);
  const float x0 = static_cast<float>(origins[2 * t + 1]);

  float xs[kPixPerThread], ys[kPixPerThread], sfx[kPixPerThread];
  float gr[kPixPerThread], gg[kPixPerThread], gb[kPixPerThread],
      ga[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    xs[k] = x0 + static_cast<float>(p % tw) + kPixelOffset;
    ys[k] = y0 + static_cast<float>(p / tw) + kPixelOffset;
    sfx[k] = 0.0f;
    const bool in = p < P;
    const long long base = static_cast<long long>(t) * 3 * P + p;
    gr[k] = in ? g_rgb[base] : 0.0f;
    gg[k] = in ? g_rgb[base + P] : 0.0f;
    gb[k] = in ? g_rgb[base + 2 * P] : 0.0f;
    ga[k] = in ? g_alpha[static_cast<long long>(t) * P + p] : 0.0f;
  }

  for (int j = walked - 1; j >= 0; --j) {
    const long long row0 = start + static_cast<long long>(j) * G;
    const int nrows = static_cast<int>(min(static_cast<long long>(G),
                                           count - static_cast<long long>(j) * G));
    __syncthreads();  // the previous chunk's rows and partials are consumed
    const float4* src = reinterpret_cast<const float4*>(inst + row0 * kFeat);
    for (int i = threadIdx.x; i < nrows * (kFeat / 4); i += kThreads) {
      smem4[i] = src[i];
    }
    __syncthreads();

    float t_in[kPixPerThread];
    const float* tb = tbounds + (row0 / G) * P;
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) {
      const int p = threadIdx.x + k * kThreads;
      t_in[k] = p < P ? tb[p] : 0.0f;
    }

    // Pass 1: tot = sum_i w_i contrib_i over the chunk.
    float cp[kPixPerThread], tot[kPixPerThread];
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) {
      cp[k] = 1.0f;
      tot[k] = 0.0f;
    }
    for (int r = 0; r < nrows; ++r) {
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

    // Pass 2: each row's gradient, reduced over the tile's pixels.
    float incl[kPixPerThread];
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) {
      cp[k] = 1.0f;
      incl[k] = 0.0f;
    }
    for (int r = 0; r < nrows; ++r) {
      const Row row = load_row<kConic>(chunk + r * kFeat);
      float acc[kGrad];
#pragma unroll
      for (int c = 0; c < kGrad; ++c) acc[c] = 0.0f;
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
      for (int c = 0; c < kGrad; ++c) {
        float v = acc[c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v += __shfl_down_sync(0xffffffffu, v, off);
        }
        if (lane == 0) partial[(warp * G + r) * kGrad + c] = v;
      }
    }
    __syncthreads();

    // Fixed-order sum of the warp partials; each row written once.
    for (int i = threadIdx.x; i < nrows * kGrad; i += kThreads) {
      const int r = i / kGrad;
      const int c = i - r * kGrad;
      float v = 0.0f;
      for (int w = 0; w < kWarps; ++w) v += partial[(w * G + r) * kGrad + c];
      if (!kConic && (c == 4 || c == 5)) {
        v = v * 4.0f * chunk[r * kFeat + c];  // d(2 s^2 + 1e-8)/ds = 4 s
      }
      if (kConic && c == 5) v = 0.0f;
      dinst[(row0 + r) * kFeat + c] = v;
    }
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) sfx[k] += tot[k];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int composite_bwd(const float* inst, long long n_rows,
                             const float* tbounds, const int* astarts,
                             const int* counts, const int* origins,
                             const int* jstop, const float* g_rgb,
                             const float* g_alpha, float* dinst, int n_tiles,
                             int th, int tw, int G, int conic, void* stream) {
  const int P = th * tw;
  const size_t smem = static_cast<size_t>(G) * kFeat * sizeof(float) +
                      static_cast<size_t>(kWarps) * G * kGrad * sizeof(float);
  if (n_tiles < 0 || th <= 0 || tw <= 0 || P > kThreads * kPixPerThread ||
      G <= 0 || smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (conic) {
    cudaFuncSetAttribute(composite_bwd_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    composite_bwd_kernel<true><<<n_tiles, kThreads, smem, s>>>(
        inst, n_rows, tbounds, astarts, counts, origins, jstop, g_rgb, g_alpha,
        dinst, tw, P, G);
  } else {
    cudaFuncSetAttribute(composite_bwd_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    composite_bwd_kernel<false><<<n_tiles, kThreads, smem, s>>>(
        inst, n_rows, tbounds, astarts, counts, origins, jstop, g_rgb, g_alpha,
        dinst, tw, P, G);
  }
  return static_cast<int>(cudaGetLastError());
}
