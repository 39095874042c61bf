// Repeated dynamic gather along one axis of a 2D table, for sm_90a.
//
// Replaces the two TPU probe kernels of scripts/dbg_dyngather_micro.py:
// `_run_kernel.kernel` (reps >= 1) and `probe_correct.kernel` (reps = 1).
// Both compute, in float32, with the sum taken sequentially in r:
//   axis 0: out[i, j] = sum_{r < reps} tab[idx[i, j] + r % 2, j]
//   axis 1: out[i, j] = sum_{r < reps} tab[i, idx[i, j] + r % 2]
// starting from 0.0f, as the TPU kernel's `acc += take_along_axis(...)` does.
// The kernel adds in the same order as its plain PyTorch version, so the two
// are bit-equal. `tab`, `idx` and `out` are [S, L] row-major (the TPU
// lowering's rule indices.shape == operand.shape is kept as the function's
// shape). The caller has checked 0 <= idx and idx + (reps > 1) < S (axis 0)
// or < L (axis 1); the kernel trusts it and never clamps.
//
// What bounds it. The function reads the table, the indices and writes the
// output once each: 3 * S * L * 4 bytes (3.54 MB at [2304, 128]), and does
// reps - 1 float32 adds an element. At the probe's shapes that is about 1 us
// of memory traffic at 3.35 TB/s against 0.14 us of adds, so it is bound by
// bytes, and far more by the launch itself at this size.
//
// Design. One thread an output element. Whatever reps is, an element reads
// at most two distinct table entries (offset 0 and offset 1), so each thread
// loads them once into registers and then adds them in r order; the table
// is read from device memory about once and the adds never wait on memory.
//  - axis 1: a block owns one row. It stages the row (L floats) in shared
//    memory with coalesced loads, and each thread's gather then reads
//    on-chip (L <= 12288, so a row fits the 48 KB a block gets by default).
//  - axis 0: an element gathers from anywhere in its column, so no block's
//    shared memory could hold what it needs (a column band of 8 is 73.7 KB
//    at S = 2304). The whole table (1.18 MB) fits the 50 MB L2 instead:
//    threads read it through the read-only path (__ldg), with neighbouring
//    threads on neighbouring columns, so a warp's loads from one row
//    coalesce (the row-broadcast pattern) and random rows cost one 32-byte
//    sector a lane.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowFloats = 12288;  // 48 KB of shared memory a block

__device__ __forceinline__ float rep_sum(float v0, float v1, int reps) {
  float acc = 0.0f;
  for (int r = 0; r < reps; ++r) acc += (r & 1) ? v1 : v0;
  return acc;
}

__global__ void __launch_bounds__(kThreads)
dyngather_axis0(const float* __restrict__ tab, const int* __restrict__ idx,
                float* __restrict__ out, long long n, int L, int reps) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) return;
  const long long j = e % L;
  const long long k = __ldg(idx + e);
  const float v0 = __ldg(tab + k * L + j);
  const float v1 = reps > 1 ? __ldg(tab + (k + 1) * L + j) : 0.0f;
  out[e] = rep_sum(v0, v1, reps);
}

__global__ void __launch_bounds__(kThreads)
dyngather_axis1(const float* __restrict__ tab, const int* __restrict__ idx,
                float* __restrict__ out, int L, int reps) {
  extern __shared__ float row[];  // L floats
  const long long base = static_cast<long long>(blockIdx.x) * L;
  for (int c = threadIdx.x; c < L; c += blockDim.x) row[c] = tab[base + c];
  __syncthreads();
  for (int c = threadIdx.x; c < L; c += blockDim.x) {
    const int k = idx[base + c];
    const float v0 = row[k];
    const float v1 = reps > 1 ? row[k + 1] : 0.0f;
    out[base + c] = rep_sum(v0, v1, reps);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int dyngather(const float* tab, const int* idx, float* out, int S,
                         int L, int axis, int reps, void* stream) {
  if (S < 0 || L < 0 || reps < 1 || (axis != 0 && axis != 1) ||
      (axis == 1 && L > kMaxRowFloats)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(S) * L;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (axis == 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    dyngather_axis0<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        tab, idx, out, n, L, reps);
  } else {
    const int threads = L >= kThreads ? kThreads : ((L + 31) / 32) * 32;
    dyngather_axis1<<<S, threads, static_cast<size_t>(L) * sizeof(float), s>>>(
        tab, idx, out, L, reps);
  }
  return static_cast<int>(cudaGetLastError());
}
