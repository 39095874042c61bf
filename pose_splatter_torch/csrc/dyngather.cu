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
// What bounds it. The function reads the table and the indices and writes
// the output once each: 3 * S * L * 4 bytes (3.54 MB at [2304, 128], 1.06
// us at 3.35 TB/s), against reps - 1 float32 adds an element (0.14 us). In
// the probe's loop the 1.18 MB table and its indices stay in the 50 MB L2,
// so device memory is not what a launch waits on. What it waits on is the
// launch floor (0.8 us: a one-element zero_() replayed in a CUDA graph,
// which chip_smoke.py measures beside the kernel), two rounds of dependent
// loads (the indices, then the table) and, on axis 0, the L2 sectors: an
// element gathered from a random row is a 32-byte sector of its own, 9.4
// MB of sectors an offset at [2304, 128] for 1.18 MB of table.
//
// Design. Whatever reps is, an element reads at most two distinct table
// entries (offsets 0 and 1): each thread loads them once into registers
// and then adds them in r order, two terms a step, so the adds never wait
// on memory and no select sits in the loop.
//  - The vector path (L % 4 == 0 and tab, idx and out 16-byte aligned): a
//    thread owns a quad, 4 consecutive elements of a row: one 16-byte load
//    of its indices, its table loads, one 16-byte store.
//    axis 0: a block owns a band of 16 columns and a part of the rows (144
//    rows, 576 threads, 128 blocks at [2304, 128]: one block an SM, so the
//    band's sectors that a block gathers again hit its SM's L1). Its table
//    loads (8, or 4 with reps = 1) all issue through the read-only path
//    before the first add; where the quad's 4 indices agree (the row
//    broadcast), each offset's 4 floats come in one 16-byte load. On the
//    card this beat one quad a thread in row order on random rows and was
//    about even on the broadcast; staging the band in shared memory (TMA,
//    multicast to a cluster) and gathering from a cluster's distributed
//    shared memory were slower than either.
//    axis 1: a block owns R = max(1, 1024 / L) consecutive rows, contiguous
//    in memory (8 rows = 4 KB at L = 128, 288 blocks at S = 2304; one row
//    of 48 KB at L = 12288, with the dynamic shared memory limit raised).
//    One thread copies them into shared memory with one bulk copy (the
//    TMA's `cp.async.bulk`, completed on an mbarrier) while every thread
//    loads its first indices with 16-byte loads; then the gathers read
//    shared memory. The last block copies only the rows that are left.
//  - The scalar path (L % 4 != 0, or a pointer that is not 16-byte aligned,
//    as a contiguous view into a larger tensor may be): one thread an
//    element; axis 1 stages its block's one row with plain loads, axis 0
//    reads the table through the read-only path.
// The C entry returns which path it launched.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowFloats = 12288;          // 48 KB of shared memory a row
constexpr int kBlockFloats = 4 * kThreads;    // axis 1: one quad a thread
constexpr int kMaxDevices = 64;
constexpr int kBandQuads = 4;      // axis 0: a band is 4 quads, 16 columns
constexpr int kMaxBandRows = 256;  // axis 0: rows a block walks at once
constexpr int kBarrierBytes = 16;  // axis 1: the mbarrier after the rows
// Returned by the C entry after a launch; negative, so never a CUDA error.
constexpr int kPathScalar = -1;
constexpr int kPathVector = -2;

// acc = 0; acc += v0; acc += v1; acc += v0; ... (reps terms): the order of
// the plain version's loop, taken two terms a step with no select.
__device__ __forceinline__ float rep_sum(float v0, float v1, int reps) {
  float acc = 0.0f;
  int r = 0;
#pragma unroll 4
  for (; r + 2 <= reps; r += 2) {
    acc += v0;
    acc += v1;
  }
  if (r < reps) acc += v0;
  return acc;
}

__device__ __forceinline__ float4 rep_sum4(float4 v0, float4 v1, int reps) {
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int r = 0;
#pragma unroll 4
  for (; r + 2 <= reps; r += 2) {
    acc.x += v0.x; acc.y += v0.y; acc.z += v0.z; acc.w += v0.w;
    acc.x += v1.x; acc.y += v1.y; acc.z += v1.z; acc.w += v1.w;
  }
  if (r < reps) {
    acc.x += v0.x; acc.y += v0.y; acc.z += v0.z; acc.w += v0.w;
  }
  return acc;
}

// ---- scalar path ----------------------------------------------------------

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

// ---- vector path ----------------------------------------------------------

// A block owns a band of kBandQuads quads (16 columns) of `rows` rows
// starting at row part * rows, one quad a thread, walking the rows
// blockDim.x / kBandQuads at a time. Block b is band b % bands, part
// b / bands.
__global__ void __launch_bounds__(4 * kMaxBandRows)
dyngather_axis0_vec(const float* __restrict__ tab, const int4* __restrict__ idx,
                    float4* __restrict__ out, int S, int L, int rows, int reps) {
  const int row_quads = L / 4;
  const int bands = (row_quads + kBandQuads - 1) / kBandQuads;
  const int band = blockIdx.x % bands;
  const int cq = band * kBandQuads + threadIdx.x % kBandQuads;  // column quad
  if (cq >= row_quads) return;
  const long long j = cq * 4ll;  // the quad's first column
  const int first = (blockIdx.x / bands) * rows;
  const int last = min(first + rows, S);
  for (int i = first + threadIdx.x / kBandQuads; i < last;
       i += blockDim.x / kBandQuads) {
    const long long q = static_cast<long long>(i) * row_quads + cq;
    const int4 k = __ldg(idx + q);
    float4 v0, v1 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (k.x == k.y && k.y == k.z && k.z == k.w) {
      const float* src = tab + k.x * static_cast<long long>(L) + j;
      v0 = __ldg(reinterpret_cast<const float4*>(src));
      if (reps > 1) v1 = __ldg(reinterpret_cast<const float4*>(src + L));
    } else {
      const float* c0 = tab + k.x * static_cast<long long>(L) + j;
      const float* c1 = tab + k.y * static_cast<long long>(L) + j + 1;
      const float* c2 = tab + k.z * static_cast<long long>(L) + j + 2;
      const float* c3 = tab + k.w * static_cast<long long>(L) + j + 3;
      v0 = make_float4(__ldg(c0), __ldg(c1), __ldg(c2), __ldg(c3));
      if (reps > 1) {
        v1 = make_float4(__ldg(c0 + L), __ldg(c1 + L), __ldg(c2 + L),
                         __ldg(c3 + L));
      }
    }
    out[q] = rep_sum4(v0, v1, reps);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__global__ void __launch_bounds__(kThreads)
dyngather_axis1_vec(const float* __restrict__ tab, const int4* __restrict__ idx,
                    float4* __restrict__ out, int S, int L, int rows_per_block,
                    int reps) {
  // rows_per_block * L floats, then the mbarrier (L % 4 == 0: 16-byte
  // aligned). No static shared memory, so the rows start at offset 0.
  extern __shared__ __align__(128) float rows[];
  const int r0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, S - r0);
  const int row_quads = L / 4;
  const int nq = nrows * row_quads;
  const long long q0 = static_cast<long long>(r0) * row_quads;
  const uint32_t b = smem_addr(rows + rows_per_block * L);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(nrows) * L * 4u;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(b), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem_addr(rows)), "l"(tab + static_cast<long long>(r0) * L),
           "r"(bytes), "r"(b)
        : "memory");
  }
  // The first quad's indices load while the copy is in flight.
  int q = threadIdx.x;
  int4 k = q < nq ? __ldg(idx + q0 + q) : make_int4(0, 0, 0, 0);
  mbar_wait(b, 0);
  for (; q < nq; q += kThreads) {
    const int qn = q + kThreads;
    const int4 kn = qn < nq ? __ldg(idx + q0 + qn) : make_int4(0, 0, 0, 0);
    const float* row = rows + (q / row_quads) * L;
    const float4 v0 = make_float4(row[k.x], row[k.y], row[k.z], row[k.w]);
    const float4 v1 = reps > 1
        ? make_float4(row[k.x + 1], row[k.y + 1], row[k.z + 1], row[k.w + 1])
        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    out[q0 + q] = rep_sum4(v0, v1, reps);
    k = kn;
  }
}

// The current device's SM count, once a device (0 where a query failed);
// the first call also lets dyngather_axis1_vec take a row of kMaxRowFloats
// beside its mbarrier.
int sm_count(int dev) {
  static int cached[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return 0;
  if (cached[dev] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ||
        cudaFuncSetAttribute(dyngather_axis1_vec,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxRowFloats * static_cast<int>(sizeof(float)) +
                                 kBarrierBytes)) {
      return 0;
    }
    cached[dev] = sms;
  }
  return cached[dev];
}

}  // namespace

// Launches on `stream`. Returns a CUDA error code (> 0) if the arguments
// are refused or the launch failed, else the path launched: -1 scalar,
// -2 vector (0: nothing to launch, S * L = 0).
extern "C" int dyngather(const float* tab, const int* idx, float* out, int S,
                         int L, int axis, int reps, void* stream) {
  if (S < 0 || L < 0 || reps < 1 || (axis != 0 && axis != 1) ||
      (axis == 1 && L > kMaxRowFloats)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(S) * L;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(tab) |
                         reinterpret_cast<uintptr_t>(idx) |
                         reinterpret_cast<uintptr_t>(out);
  int path = kPathScalar;
  if (L % 4 == 0 && ptrs % 16 == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int sms = sm_count(dev);
    if (sms <= 0) {
      err = cudaGetLastError();
      return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
    }
    const auto* idx4 = reinterpret_cast<const int4*>(idx);
    auto* out4 = reinterpret_cast<float4*>(out);
    if (axis == 0) {
      // As many parts of the rows as leave each block an SM: a band's
      // rows split over SMs / bands blocks, a multiple of 8 rows each.
      const int bands = (L / 4 + kBandQuads - 1) / kBandQuads;
      const int parts = sms / bands > 1 ? sms / bands : 1;
      const int rows = ((S + parts - 1) / parts + 7) / 8 * 8;
      const int threads = kBandQuads * (rows < kMaxBandRows ? rows : kMaxBandRows);
      const long long blocks =
          static_cast<long long>(bands) * ((S + rows - 1) / rows);
      if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
      dyngather_axis0_vec<<<static_cast<unsigned>(blocks), threads, 0, s>>>(
          tab, idx4, out4, S, L, rows, reps);
    } else {
      int rows = kBlockFloats / L;
      rows = rows < 1 ? 1 : (rows > S ? S : rows);
      const int blocks = (S + rows - 1) / rows;
      const size_t smem =
          static_cast<size_t>(rows) * L * sizeof(float) + kBarrierBytes;
      dyngather_axis1_vec<<<blocks, kThreads, smem, s>>>(tab, idx4, out4, S, L,
                                                         rows, reps);
    }
    path = kPathVector;
  } else if (axis == 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    dyngather_axis0<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        tab, idx, out, n, L, reps);
  } else {
    const int threads = L >= kThreads ? kThreads : ((L + 31) / 32) * 32;
    dyngather_axis1<<<S, threads, static_cast<size_t>(L) * sizeof(float), s>>>(
        tab, idx, out, L, reps);
  }
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? static_cast<int>(err) : path;
}
