// The carve's frontmost-occupied-voxel visibility for both carve
// thresholds, for sm_90a (ops/carving.py::ray_cast_visibility_pair).
//
// It replaces no TPU kernel: the JAX carve (pose_splatter_tpu/ops/
// carving.py::ray_cast_visibility_pair) is a lax.sort by (pixel, distance)
// and a cumsum and a segmented cummax in sorted order. In PyTorch those two
// scans run one 512-thread block a row, so the [C, N] scans of the carve
// ran on C = 5 of the card's 132 SMs, each streaming a row of N voxels in
// order: 37.7 ms a carve at N = 3,932,160, beside a 64-bit sort of all C*N
// pairs and its gathers and scatters. This kernel computes the same
// booleans with no sort and no scan.
//
// What it computes. Voxel n is visible from camera c for threshold k iff
// occ_k[n] and its key
//   key = (float_bits(dists[c, n]) << 32) | n
// is the least key of the voxels of occ_k on its pixel flat[c, n]. A
// distance is >= 0, so its bit pattern orders as the float; the low word
// breaks ties by the lower voxel index, as the stable sort did. So the
// winner of each pixel is the first occupied voxel of its segment in
// (distance, voxel index) order: bit for bit the sort and scans' result.
// The minimum is exact and does not depend on the order of the atomics, so
// the result is the same on every run.
//
//  1. The wrapper's scratch table [2, C, P] of 64-bit keys (P = H * W) is
//     filled with all-ones bits (one cudaMemsetAsync): greater than any key.
//  2. min_keys: one thread a (c, n). A voxel in neither set returns after
//     reading its two flags; otherwise it loads its distance and pixel and
//     takes atomicMin of its key into table 0 if occ1[n] and table 1 if
//     occ2[n] (the sets need not be nested).
//  3. mark_visible: one thread a (c, n) writes
//     vis_k[c, n] = occ_k[n] && table_k[c, flat[c, n]] == key.
//
// What bounds it: bytes, with no arithmetic to speak of. The function
// itself needs, counted once each, the flags (2 N bytes), the booleans
// written (2 C N) and each occupied voxel's distances and pixels (12 C
// bytes): at N = 3,932,160, C = 5 that is 7.9 + 39.3 MB and 0.06 MB per
// thousand occupied voxels, about 54 MB with the high-res scene's 110k,
// 0.016 ms at 3.35 TB/s. The table's fill (16 C P bytes, 94.4 MB at
// P = 1152 * 1024, 0.028 ms) is this design's own cost on top; chip_smoke.py
// prints both bounds at each shape it times. Were every voxel occupied, the
// distances and pixels of all C N pairs would add 236 MB. Design against
// it: the flags are read first and an unoccupied
// voxel loads nothing else, every load and store is coalesced along n (a
// block a run of 256 voxels of one camera, blockIdx.y the camera), and
// atomics come only from occupied voxels, a few a pixel, into a table that
// stays in L2 at every shape but the largest.
// Neither pass allocates or synchronises, so a CUDA graph captures them.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned long long key_of(const float* dists,
                                                     long long cn,
                                                     long long n) {
  return (static_cast<unsigned long long>(__float_as_uint(dists[cn])) << 32) |
         static_cast<unsigned long long>(n);
}

__global__ void min_keys(const float* __restrict__ dists,
                         const int64_t* __restrict__ flat,
                         const uint8_t* __restrict__ occ1,
                         const uint8_t* __restrict__ occ2,
                         unsigned long long* __restrict__ table, long long N,
                         long long P) {
  const long long n = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (n >= N) return;
  const uint8_t o1 = occ1[n], o2 = occ2[n];
  if (!(o1 | o2)) return;
  const long long c = blockIdx.y;
  const long long cn = c * N + n;
  const unsigned long long key = key_of(dists, cn, n);
  unsigned long long* t = table + c * P + flat[cn];
  if (o1) atomicMin(t, key);
  if (o2) atomicMin(t + gridDim.y * P, key);  // table 1 after table 0
}

__global__ void mark_visible(const float* __restrict__ dists,
                             const int64_t* __restrict__ flat,
                             const uint8_t* __restrict__ occ1,
                             const uint8_t* __restrict__ occ2,
                             const unsigned long long* __restrict__ table,
                             uint8_t* __restrict__ vis, long long N,
                             long long P) {
  const long long n = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (n >= N) return;
  const long long c = blockIdx.y;
  const long long cn = c * N + n;
  const uint8_t o1 = occ1[n], o2 = occ2[n];
  uint8_t v1 = 0, v2 = 0;
  if (o1 | o2) {
    const unsigned long long key = key_of(dists, cn, n);
    const unsigned long long* t = table + c * P + flat[cn];
    v1 = o1 && t[0] == key;
    v2 = o2 && t[gridDim.y * P] == key;
  }
  vis[cn] = v1;  // vis [2, C, N]: threshold 1, then threshold 2
  vis[gridDim.y * N + cn] = v2;
}

}  // namespace

// dists [C, N] float32 (>= 0), flat [C, N] int64 in [0, P), occ1 and occ2
// [N] bool, table [2, C, P] 64-bit scratch, vis [2, C, N] bool; all
// contiguous on one device. Returns 0 or the CUDA error of a launch.
extern "C" int carve_visibility(const float* dists, const int64_t* flat,
                                const uint8_t* occ1, const uint8_t* occ2,
                                unsigned long long* table, uint8_t* vis,
                                long long C, long long N, long long P,
                                void* stream) {
  if (C < 0 || C > 65535 || N < 0 || N >= (1LL << 32) || P <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      table, 0xFF, static_cast<size_t>(2 * C * P) * sizeof(unsigned long long),
      s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((N + kThreads - 1) / kThreads),
                  static_cast<unsigned>(C));
  min_keys<<<grid, kThreads, 0, s>>>(dists, flat, occ1, occ2, table, N, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mark_visible<<<grid, kThreads, 0, s>>>(dists, flat, occ1, occ2, table, vis,
                                         N, P);
  return static_cast<int>(cudaGetLastError());
}
