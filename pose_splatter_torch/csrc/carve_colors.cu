// The exact carve's colour sum and volume assembly for both carve
// thresholds, for sm_90a (ops/carving.py::carve_colors_pair).
//
// It replaces no TPU kernel: the JAX carve (pose_splatter_tpu/ops/
// carving.py::carve_volume) leaves this einsum and its elementwise ops to
// XLA. In PyTorch the colour sum, einsum("cn,cnk->nk", weights, sampled),
// lowers to a bmm whose batch is the voxel count N, which cuBLAS runs as a
// batched gemv of N products of 1 x C by C x 3, one block a product:
// 5.8 ms a threshold at N = 3,932,160, beside a dozen elementwise passes
// over [C, N] and [4, N] a threshold. This kernel computes the same volume
// in one pass, with no [C, N] weights or [N, 3] colours ever written.
//
// What it computes, for each voxel n and each threshold t in (1, 2):
// w_c = 1 where vis_t[c, n], else nonvisible_weight, over max(sum_c w_c,
// 1e-8) (the sum c ascending); the colour sum_c w_c * s_c; the volume
// v_t = (occ_t, colour where occ_t else volume_fill_color); and
//   out[:, n] = (0 + v_1 / 2) + v_2 / 2,
// the plain version's order. The colour's sum is taken in the order of
// the batched gemv that the plain version's einsum runs on the card:
// the first ceil(C / 2) cameras and the rest each as a chain of fused
// multiply-adds from 0 (explicit fmaf: the build's -fmad=false does not
// fuse them), then the two halves added. Measured on the card against
// cuBLAS's gemv2N at C = 3, 4, 5, 6 and 8, every colour of 50,000 voxels
// was equal bit for bit, so on the card this kernel's volume is the plain
// version's bit for bit, and the carve's output does not move. cuBLAS runs
// the N gemvs in chunks of 65,535; a short last chunk (the last 60 voxels
// at high res) goes to another of its kernels, which sums in another
// order, and there the two can differ by an ulp.
//
// What bounds it: bytes. Read once, the sampled colours are [C, N, 4]
// float32 when the carve's fused gather hands over its stride-4 view (315
// MB at high res, C = 5), the two visibility sets 2 C N bytes (39 MB),
// the occupancy flags 2 N (7.9 MB), and the [4, N] volume written is 16 N
// (63 MB): about 425 MB, 0.13 ms at 3.35 TB/s. But a voxel outside both
// occupied sets takes the fill whatever it sampled, so what these inputs
// need is the flags and the volume for every voxel and the colours and
// visibility of the occupied ones only: 71 MB at high res with the
// benchmark scene's ~110k occupied voxels. Design against it: one thread
// a voxel; the flags are read first and a voxel in neither set loads
// nothing else; an occupied voxel reads its visibility into a bit mask
// (at most 64 cameras), then each camera's colour once (one 16-byte load
// from the stride-4 view, three floats from a [C, N, 3] tensor), and sums
// both thresholds' colours from that one read; neighbouring threads take
// neighbouring voxels, so every load and every store of the channel-major
// volume is coalesced. The kernel neither allocates nor synchronises, so a
// CUDA graph captures it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxCameras = 64;  // one bit a camera in a mask

struct Rgb {
  float r, g, b;
};

template <bool kVec4>
__device__ __forceinline__ Rgb load_rgb(const float* __restrict__ sampled,
                                        long long off) {
  if (kVec4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(sampled + off));
    return {v.x, v.y, v.z};
  }
  return {__ldg(sampled + off), __ldg(sampled + off + 1),
          __ldg(sampled + off + 2)};
}

__device__ __forceinline__ void fma_into(Rgb& acc, float w, const Rgb& s) {
  acc = {__fmaf_rn(w, s.r, acc.r), __fmaf_rn(w, s.g, acc.g),
         __fmaf_rn(w, s.b, acc.b)};
}

template <bool kVec4>
__global__ void carve_colors_kernel(const float* __restrict__ sampled,
                                    long long stride_c, long long stride_n,
                                    const uint8_t* __restrict__ vis1,
                                    const uint8_t* __restrict__ vis2,
                                    const uint8_t* __restrict__ occ1,
                                    const uint8_t* __restrict__ occ2,
                                    float nonvisible_weight, float fill,
                                    float* __restrict__ out, int C,
                                    long long N) {
  const long long n = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (n >= N) return;
  const bool o1 = occ1[n] != 0, o2 = occ2[n] != 0;
  Rgb c1 = {fill, fill, fill}, c2 = {fill, fill, fill};
  if (o1 || o2) {
    // Visibility bits and the weights' sums, c ascending (the plain
    // version's sum over dim 0).
    unsigned long long m1 = 0, m2 = 0;
    float sum1 = 0.f, sum2 = 0.f;
    for (int c = 0; c < C; ++c) {
      const long long cn = static_cast<long long>(c) * N + n;
      const bool v1 = o1 && vis1[cn] != 0;
      const bool v2 = o2 && vis2[cn] != 0;
      m1 |= static_cast<unsigned long long>(v1) << c;
      m2 |= static_cast<unsigned long long>(v2) << c;
      sum1 = sum1 + (v1 ? 1.f : nonvisible_weight);
      sum2 = sum2 + (v2 ? 1.f : nonvisible_weight);
    }
    const float norm1 = fmaxf(sum1, 1e-8f), norm2 = fmaxf(sum2, 1e-8f);
    // Each half of the cameras (the first ceil(C / 2), then the rest) is
    // a chain of fused multiply-adds from 0, and the halves are added.
    const int half = (C + 1) / 2;
    Rgb p1 = {0.f, 0.f, 0.f}, p2 = {0.f, 0.f, 0.f};
    Rgb q1 = {0.f, 0.f, 0.f}, q2 = {0.f, 0.f, 0.f};
    for (int c = 0; c < C; ++c) {
      const Rgb s = load_rgb<kVec4>(sampled, c * stride_c + n * stride_n);
      const float w1 = ((m1 >> c) & 1ull ? 1.f : nonvisible_weight) / norm1;
      const float w2 = ((m2 >> c) & 1ull ? 1.f : nonvisible_weight) / norm2;
      if (c < half) {
        fma_into(p1, w1, s);
        fma_into(p2, w2, s);
      } else {
        fma_into(q1, w1, s);
        fma_into(q2, w2, s);
      }
    }
    if (o1) c1 = {p1.r + q1.r, p1.g + q1.g, p1.b + q1.b};
    if (o2) c2 = {p2.r + q2.r, p2.g + q2.g, p2.b + q2.b};
  }
  const float f1 = o1 ? 1.f : 0.f, f2 = o2 ? 1.f : 0.f;
  out[n] = (0.f + f1 / 2.f) + f2 / 2.f;
  out[N + n] = (0.f + c1.r / 2.f) + c2.r / 2.f;
  out[2 * N + n] = (0.f + c1.g / 2.f) + c2.g / 2.f;
  out[3 * N + n] = (0.f + c1.b / 2.f) + c2.b / 2.f;
}

}  // namespace

// sampled: C x N x 3 float32 at element strides (stride_c, stride_n, 1);
// vis1, vis2 [C, N] and occ1, occ2 [N] bool; out [4, N] float32; all
// contiguous but sampled, on one device. The 16-byte path takes a
// 16-byte-aligned sampled with stride_n 4 and stride_c a multiple of 4.
// Returns 0 or the CUDA error of the launch.
extern "C" int carve_colors(const float* sampled, long long stride_c,
                            long long stride_n, const uint8_t* vis1,
                            const uint8_t* vis2, const uint8_t* occ1,
                            const uint8_t* occ2, float nonvisible_weight,
                            float fill, float* out, long long C, long long N,
                            void* stream) {
  if (C < 0 || C > kMaxCameras || N < 0 || stride_c < 0 || stride_n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((N + kThreads - 1) / kThreads);
  const bool vec4 = stride_n == 4 && stride_c % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(sampled) % 16 == 0;
  if (vec4) {
    carve_colors_kernel<true><<<blocks, kThreads, 0, s>>>(
        sampled, stride_c, stride_n, vis1, vis2, occ1, occ2,
        nonvisible_weight, fill, out, static_cast<int>(C), N);
  } else {
    carve_colors_kernel<false><<<blocks, kThreads, 0, s>>>(
        sampled, stride_c, stride_n, vis1, vis2, occ1, occ2,
        nonvisible_weight, fill, out, static_cast<int>(C), N);
  }
  return static_cast<int>(cudaGetLastError());
}
