// Load-balancing search (LBS) for the merge-path expansion, kernel B1.
//
// Replaces the TPU kernel `lbs_pallas` (body `_lbs_kernel`) in
// src/repro/kernels/frontier_expand/kernel.py.  Given `scan`, the inclusive
// scan of the popped chunks' degree sums (W entries), every work unit
// k < budget gets
//
//   owner(k) = #{j : scan[j] <= k}          (first j with scan[j] > k, or W)
//   rank(k)  = k - (owner(k) ? scan[owner(k) - 1] : 0)
//
// bit-equal to the reference `lbs_ref` for every k < budget, including the
// units past the scan's total.
//
// What bounds it on an H100: bytes.  The function reads W * 4 bytes and
// writes 8 bytes per work unit; the search itself is log2(W) probes per
// unit.  The Pallas kernel counted `scan[j] <= k` over a [1024, W] tile
// (O(W) work per unit) because the TPU's vector unit has no per-lane
// gather.  Here each thread owns its address, so each unit runs a
// branchless upper-bound binary search over a copy of the scan that its
// block staged in shared memory: O(log W) shared-memory probes, the scan
// read once per block, stores coalesced (neighbouring threads write
// neighbouring k).  A grid-stride loop over a grid of a few blocks per SM
// keeps the staging cost at a few hundred copies of the scan, served from
// L2.  Shared memory above 48 KB is opted into; a scan larger than the
// block's limit (227 KB on an H100) is searched in global memory instead.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;

__device__ __forceinline__ int upper_bound(const int* __restrict__ s, int w,
                                           int k) {
  int base = 0;
  int len = w;
  while (len > 0) {
    const int half = len >> 1;
    const int mid = base + half;
    const bool right = s[mid] <= k;
    base = right ? mid + 1 : base;
    len = right ? len - half - 1 : half;
  }
  return base;
}

__device__ __forceinline__ void search_units(const int* __restrict__ s, int w,
                                             int* __restrict__ owner,
                                             int* __restrict__ rank,
                                             int budget) {
  const int stride = gridDim.x * blockDim.x;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < budget;
       k += stride) {
    const int o = upper_bound(s, w, k);
    owner[k] = o;
    rank[k] = k - (o > 0 ? s[o - 1] : 0);
  }
}

__global__ void lbs_shared(const int* __restrict__ scan, int w,
                           int* __restrict__ owner, int* __restrict__ rank,
                           int budget) {
  extern __shared__ int s_scan[];
  for (int i = threadIdx.x; i < w; i += blockDim.x) s_scan[i] = scan[i];
  __syncthreads();
  search_units(s_scan, w, owner, rank, budget);
}

__global__ void lbs_global(const int* __restrict__ scan, int w,
                           int* __restrict__ owner, int* __restrict__ rank,
                           int budget) {
  search_units(scan, w, owner, rank, budget);
}

// The SM count and the shared-memory opt-in limit of each device, read
// once: the drain launches this kernel every round and is host-bound.
struct DeviceLimits {
  int sms = 0;
  int smem_optin = 0;
  int smem_set = 48 * 1024;  // dynamic shared memory lbs_shared may use
};
constexpr int kMaxDevices = 64;
DeviceLimits g_limits[kMaxDevices];

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 on success).
extern "C" int lbs_launch(const int* scan, int w, int* owner, int* rank,
                          int budget, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceLimits& lim = g_limits[dev];
  if (lim.sms == 0) {
    err = cudaDeviceGetAttribute(&lim.smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&lim.sms, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }

  const int wanted = (budget + kThreads - 1) / kThreads;
  const int most = lim.sms * kBlocksPerSm;
  const int blocks = wanted < most ? wanted : most;
  const size_t bytes = static_cast<size_t>(w) * sizeof(int);
  if (bytes <= static_cast<size_t>(lim.smem_optin)) {
    if (bytes > static_cast<size_t>(lim.smem_set)) {
      err = cudaFuncSetAttribute(lbs_shared,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
      lim.smem_set = static_cast<int>(bytes);
    }
    lbs_shared<<<blocks, kThreads, bytes, stream>>>(scan, w, owner, rank,
                                                    budget);
  } else {
    lbs_global<<<blocks, kThreads, 0, stream>>>(scan, w, owner, rank, budget);
  }
  return cudaGetLastError();
}
