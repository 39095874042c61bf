// The weight and bias gradients of a 3x3x3 float32 convolution (stride 1,
// zero padding 1, batch 1), for sm_90a (ops/conv3d.py::conv3d_weight_grad).
//
// It replaces no TPU kernel: the JAX package leaves its U-Nets'
// convolutions to XLA. On the card cuDNN takes these weight gradients with
// wgrad_alg1_nd_float_engine, which every engine choice and its
// autotuning pick, at about 2 % of the float32 rate: 8.8 ms of a 2D train
// step's final U-Net, about 54 ms of a high-res one. This kernel computes,
// for x [1, Cin, D, H, W] and the output gradient gy [1, Cout, D, H, W],
//   gw[co, ci, a, b, c] = sum_{d,h,w} gy[co, d, h, w] x[ci, d+a-1, h+b-1, w+c-1]
//   gb[co]              = sum_{d,h,w} gy[co, d, h, w]
// with x zero outside the volume.
//
// What bounds it: float32 FMAs. A weight entry is a dot product over all
// D*H*W positions, so the work is 2 * Cout * Cin * 27 * D*H*W operations
// (3.4 GFLOP for the 2D crop's 16 -> 8 convolution) against reading x and
// gy once (47 MB there): about 70 operations a byte, far above the card's
// 20 (67 TFLOP/s of FFMA over 3.35 TB/s). The outputs are tiny (864 to
// 13,824 entries), so the reduction over positions is what has to be cut
// up, and each loaded value has to feed many FMAs from registers.
//
// Design.
//  - A warp owns one (group of 4 output channels, input channel) pair and
//    keeps its 4 x 27 weight entries in registers. Its 32 lanes cover 128
//    consecutive positions of one d-slice: each lane 4 neighbouring w of a
//    row (W / 4 lanes a row, 128 / W rows a step), read as one 16-byte
//    load, so every load of a warp is 512 contiguous bytes.
//  - A step loads gy's 4 channels at the lane's 4 positions (4 loads) and,
//    for each of the 9 (d, h) neighbour rows, x's 4 values (9 loads); the
//    w-1 and w+4 neighbours come from the adjacent lanes by shuffle (0 at
//    the row's ends, the padding). Each x value then feeds 3 taps x 4
//    channels: 432 FMAs a lane for 13 loads and 18 shuffles. The (d, h)
//    halo is read again by the neighbouring steps and warps through L1.
//  - The reduction over positions is split: the 4 warps of a block take 4
//    pairs over one chunk of consecutive steps (warps of one input
//    channel share x in L1); the grid is (chunks, pair groups), sized by
//    the wrapper from the shape alone to fill the card's 132 SMs at 3
//    blocks each in one wave. At the end of its chunk a warp sums its
//    lanes by a shuffle butterfly and writes one partial an entry.
//  - A second pass sums each entry's partials, one warp an entry, in a
//    fixed order. No floating-point atomics: the result is the same, bit
//    for bit, on every run. The bias gradient is the column of ones: the
//    warps of input channel 0 also add up gy.
//  - The FMAs are written as __fmaf_rn (the build turns contraction off).
//    The sums run in another order than cuDNN's or than the plain version's,
//    so the three agree to float32 rounding, not bit for bit.
// Neither pass allocates or synchronises, so a CUDA graph captures them.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                  // warps (pairs) a block
constexpr int kThreads = 32 * kWarps;
constexpr int kCo = 4;                     // output channels a warp holds
constexpr int kTaps = 27;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) v += __shfl_xor_sync(kFull, v, k);
  return v;
}

// part [n_out, n_chunks]: entry o's partial of chunk k at o * n_chunks + k,
// the entries in gw's order [Cout, Cin, 3, 3, 3] and then gb's [Cout].
__global__ void __launch_bounds__(kThreads, 3)
wgrad_partials(const float* __restrict__ x, const float* __restrict__ gy,
               float* __restrict__ part, int cin, int cout, int D, int H,
               int W, int steps_per_chunk, int n_chunks) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = cout / kCo;
  const int pair = blockIdx.y * kWarps + warp;
  if (pair >= groups * cin) return;  // the whole warp: no shuffle is left
  const int ci = pair / groups, g = pair % groups;

  const int lpr = W >> 2;              // lanes a row
  const int rps = 32 / lpr;            // rows a step
  const int col = lane % lpr;
  const int w0 = col * 4;
  const int row = lane / lpr;
  const int sps = (H + rps - 1) / rps;  // steps a d-slice
  const int n_steps = D * sps;
  const int s0 = blockIdx.x * steps_per_chunk;
  const int s1 = min(n_steps, s0 + steps_per_chunk);
  // Offsets in 32 bits: the wrapper holds each tensor under 2^31 elements.
  const int plane = H * W;
  const int vol = D * plane;
  const float* xc = x + ci * vol;
  const float* gc = gy + g * kCo * vol;

  float acc[kCo][9][3];
#pragma unroll
  for (int m = 0; m < kCo; ++m)
#pragma unroll
    for (int r = 0; r < 9; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[m][r][c] = 0.f;
  float bacc[kCo] = {0.f, 0.f, 0.f, 0.f};

  int d = s0 / sps, h0 = (s0 % sps) * rps;
  for (int s = s0; s < s1; ++s) {
    const int h = h0 + row;
    const bool valid = h < H;
    const int at = d * plane + h * W + w0;
    float gv[kCo][4];
#pragma unroll
    for (int m = 0; m < kCo; ++m) {
      const float4 v = valid ? load4(gc + m * vol + at)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      gv[m][0] = v.x; gv[m][1] = v.y; gv[m][2] = v.z; gv[m][3] = v.w;
    }
    if (ci == 0) {
#pragma unroll
      for (int m = 0; m < kCo; ++m)
#pragma unroll
        for (int p = 0; p < 4; ++p) bacc[m] += gv[m][p];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int dd = d + a - 1;
      const bool okd = valid && dd >= 0 && dd < D;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int hh = h + b - 1;
        const bool ok = okd && hh >= 0 && hh < H;
        const float4 v =
            ok ? load4(xc + dd * plane + hh * W + w0)
               : make_float4(0.f, 0.f, 0.f, 0.f);
        float left = __shfl_up_sync(kFull, v.w, 1, lpr);
        float right = __shfl_down_sync(kFull, v.x, 1, lpr);
        if (col == 0) left = 0.f;
        if (col == lpr - 1) right = 0.f;
        const float win[6] = {left, v.x, v.y, v.z, v.w, right};
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int m = 0; m < kCo; ++m)
              acc[m][a * 3 + b][c] =
                  __fmaf_rn(gv[m][p], win[p + c], acc[m][a * 3 + b][c]);
      }
    }
    h0 += rps;
    if (h0 >= H) {
      h0 = 0;
      ++d;
    }
  }

  const int chunk = blockIdx.x;
#pragma unroll
  for (int m = 0; m < kCo; ++m) {
    const int base = ((g * kCo + m) * cin + ci) * kTaps;
#pragma unroll
    for (int r = 0; r < 9; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = warp_sum(acc[m][r][c]);
        if (lane == ((m * 27 + r * 3 + c) & 31))
          part[static_cast<long long>(base + r * 3 + c) * n_chunks + chunk] = v;
      }
  }
  if (ci == 0) {
    const int nw = cout * cin * kTaps;
#pragma unroll
    for (int m = 0; m < kCo; ++m) {
      const float v = warp_sum(bacc[m]);
      if (lane == m)
        part[static_cast<long long>(nw + g * kCo + m) * n_chunks + chunk] = v;
    }
  }
}

// out[o] = the sum of part[o, 0..n_chunks), one warp an entry: lane l adds
// chunks l, l + 32, ... in order, then the butterfly; a fixed order.
__global__ void reduce_partials(const float* __restrict__ part,
                                float* __restrict__ out, int n_out,
                                int n_chunks) {
  const long long o =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (o >= n_out) return;  // the whole warp
  const float* p = part + o * n_chunks;
  float s = 0.f;
  for (int k = lane; k < n_chunks; k += 32) s += p[k];
  s = warp_sum(s);
  if (lane == 0) out[o] = s;
}

}  // namespace

// x [1, cin, D, H, W] and gy [1, cout, D, H, W] float32, contiguous and
// 16-byte aligned; part [cout * cin * 27 + cout, n_chunks] scratch; out
// [cout * cin * 27 + cout]: gw [cout, cin, 3, 3, 3] then gb [cout]. cout a
// multiple of 4; W one of 4, 8, ..., 128; n_chunks * steps_per_chunk at
// least D * ceil(H / (128 / W)). Returns 0 or the CUDA error of a launch.
extern "C" int conv3d_wgrad(const float* x, const float* gy, float* part,
                            float* out, int cin, int cout, int D, int H,
                            int W, int steps_per_chunk, int n_chunks,
                            void* stream) {
  const bool w_ok = W >= 4 && W <= 128 && (W & (W - 1)) == 0;
  const long long rps = w_ok ? 128 / W : 1;
  const long long n_steps = static_cast<long long>(D) * ((H + rps - 1) / rps);
  if (cin < 1 || cout < kCo || cout % kCo || D < 1 || H < 1 || !w_ok ||
      steps_per_chunk < 1 || n_chunks < 1 || n_chunks > 65535 ||
      static_cast<long long>(steps_per_chunk) * n_chunks < n_steps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_out = cout * cin * kTaps + cout;
  const int pair_blocks = (cout / kCo * cin + kWarps - 1) / kWarps;
  if (pair_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  wgrad_partials<<<dim3(n_chunks, pair_blocks), kThreads, 0, s>>>(
      x, gy, part, cin, cout, D, H, W, steps_per_chunk, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = 256 / 32;
  reduce_partials<<<(n_out + per_block - 1) / per_block, 256, 0, s>>>(
      part, out, n_out, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
