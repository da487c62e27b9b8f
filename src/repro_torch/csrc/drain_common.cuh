// What the drain kernels B3 share: bfs_drain.cu, pagerank_drain.cu and
// coloring_drain.cu.
//
// Each is one cooperative launch per drain.  The grid is as many blocks as
// fit on the card at once, launched with cudaLaunchCooperativeKernel, which
// refuses a grid that could not be co-resident instead of hanging.  Every
// block pops the whole wavefront itself, into its own copy, and keeps the
// cursors in registers, updating them identically, so the loop condition is
// the same in every block without a barrier.  The pieces here:
//
//   * the carry's scalar cursors, in the order the Python wrappers pack them;
//   * int32 arithmetic that wraps as torch's does, and Python's modulo;
//   * grid_barrier: a counter and a generation word in device memory (no
//     -rdc build); a barrier that has not completed after about half a
//     minute traps, so a fault ends the launch with an error instead of
//     holding the card;
//   * block-wide exclusive scans and sums, and the inclusive scan of a
//     wavefront spread over the block's threads;
//   * upper_bound over a scan: kernel B1's search;
//   * ring_push: the round's push into the task ring at tail + rank, the
//     ranks from prefix sums (never an atomic ticket), so the ring is
//     bit-identical to TaskQueue.push; what exceeds the free slots is
//     dropped;
//   * cooperative_grid: the co-resident grid of a kernel.
//
// Values that other blocks write inside the launch are read with
// ld.global.cg (__ldcg), past the SM's incoherent L1.
#pragma once

#include <cuda_runtime.h>

#include <climits>

namespace drain {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kEmpty = INT_MIN;  // core/queue.EMPTY
constexpr unsigned kSpinLimit = 1u << 28;

// The carry's scalars, in the order the Python wrappers pack them.  A
// program with more scalars appends them after kLimit.
enum Cursor {
  kHead = 0,
  kTail,
  kDropped,
  kRounds,
  kProcessed,
  kWork,
  kSplits,
  kCounterRounds,
  kLimit,
  kCursors
};

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// Python's modulo, as torch's `%` takes it on int32.
__device__ __forceinline__ int py_mod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int ring_slot(int cursor, int cap) {
  return py_mod(cursor, cap);
}

__device__ __forceinline__ int clamp_to(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ inline void grid_barrier(unsigned int* bar) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int seen = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      unsigned spins = 0;
      while (*gen == seen) {
        __nanosleep(100);
        if (++spins > kSpinLimit) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// Exclusive scan of one int a thread over the block, with int32 wraparound;
// `total` gets the block's sum.  Every thread of the block must call it;
// `warp_sums` holds kThreads / 32 ints of shared memory.
template <int kThreads>
__device__ int block_exclusive_scan(int v, int* warp_sums, int& total) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned x = static_cast<unsigned>(v);
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = static_cast<int>(x);
  __syncthreads();
  if (warp == 0) {
    unsigned s = lane < kWarps ? static_cast<unsigned>(warp_sums[lane]) : 0u;
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, s, off);
      if (lane >= off) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = static_cast<int>(s);
  }
  __syncthreads();
  const unsigned before =
      (warp > 0 ? static_cast<unsigned>(warp_sums[warp - 1]) : 0u) + x -
      static_cast<unsigned>(v);
  total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return static_cast<int>(before);
}

template <int kThreads>
__device__ __forceinline__ int block_sum(int v, int* warp_sums) {
  int total;
  block_exclusive_scan<kThreads>(v, warp_sums, total);
  return total;
}

// The block-wide maximum of one float a thread (every thread gets it).
template <int kThreads>
__device__ float block_max(float v, float* warp_max) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  }
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  float m = warp_max[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_max[w]);
  __syncthreads();  // warp_max is reused by the next call
  return m;
}

// In place, the int32 inclusive scan of a[0 : W], where the calling thread
// owns the lanes [l0, l1) and the threads' ranges follow each other in
// thread order.  Ends with the block synchronized, so every thread may read
// every a[l].
template <int kThreads>
__device__ void inclusive_scan_lanes(int* a, int l0, int l1, int* warp_sums) {
  unsigned run = 0;
  for (int l = l0; l < l1; ++l) run += static_cast<unsigned>(a[l]);
  int unused;
  unsigned acc = static_cast<unsigned>(
      block_exclusive_scan<kThreads>(static_cast<int>(run), warp_sums,
                                     unused));
  for (int l = l0; l < l1; ++l) {
    acc += static_cast<unsigned>(a[l]);
    a[l] = static_cast<int>(acc);
  }
  __syncthreads();
}

// First j with s[j] > u, or w (kernel B1's search).
__device__ __forceinline__ int upper_bound(const int* s, int w, int u) {
  int base = 0;
  int len = w;
  while (len > 0) {
    const int half = len >> 1;
    const int mid = base + half;
    const bool right = s[mid] <= u;
    base = right ? mid + 1 : base;
    len = right ? len - half - 1 : half;
  }
  return base;
}

// The [lo, hi) share of `total` positions that block b of G takes.
__device__ __forceinline__ void block_range(int total, int b, int G, int& lo,
                                            int& hi) {
  const long long per = (static_cast<long long>(total) + G - 1) / G;
  lo = static_cast<int>(min(static_cast<long long>(b) * per,
                            static_cast<long long>(total)));
  hi = static_cast<int>(
      min(static_cast<long long>(lo) + per, static_cast<long long>(total)));
}

// The round's push.  Each block has written how many positions of its range
// [lo, hi) it keeps into block_count[blockIdx.x], and a grid barrier has
// passed since.  `item(p, value)` says whether position p is kept and sets
// its value.  Writes the kept values of [lo, hi), in position order, into
// the ring at tail + (kept positions before them); a write at or past
// `free_slots` is dropped.  Returns the round's kept count (every block
// gets it).  Every thread of the block must call it.
template <int kThreads, class Item>
__device__ int ring_push(int* buf, int cap, int tail, int free_slots,
                         const int* block_count, int lo, int hi,
                         int* warp_sums, Item item) {
  const int G = gridDim.x;
  const int tid = threadIdx.x;
  int base = 0;
  int count = 0;
  for (int c0 = 0; c0 < G; c0 += kThreads) {
    const int b = c0 + tid;
    const int v = b < G ? __ldcg(block_count + b) : 0;
    base = wrap_add(base, block_sum<kThreads>(
                              b < static_cast<int>(blockIdx.x) ? v : 0,
                              warp_sums));
    count = wrap_add(count, block_sum<kThreads>(v, warp_sums));
  }
  const int tiles = hi > lo ? (hi - lo + kThreads - 1) / kThreads : 0;
  int offset = base;
  for (int s = 0; s < tiles; ++s) {
    const int p = lo + s * kThreads + tid;
    int value = 0;
    const int keep = p < hi && item(p, value);
    int tile_total;
    const int r = wrap_add(
        offset, block_exclusive_scan<kThreads>(keep, warp_sums, tile_total));
    if (keep && r < free_slots) buf[ring_slot(wrap_add(tail, r), cap)] = value;
    offset = wrap_add(offset, tile_total);
  }
  return count;
}

struct DeviceInfo {
  int sms = 0;
  int smem_optin = 0;
  int cooperative = 0;
};
constexpr int kMaxDevices = 64;

// The current device's SM count, opt-in shared memory per block and
// cooperative-launch support, read once per device.
inline cudaError_t device_info(DeviceInfo* out) {
  static DeviceInfo cache[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& info = cache[dev];
  if (info.sms == 0) {
    err = cudaDeviceGetAttribute(&info.smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&info.cooperative,
                                 cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  *out = info;
  return cudaSuccess;
}

// The co-resident grid of `kernel` at `threads` a block and `dyn` bytes of
// dynamic shared memory (raising the kernel's limit where `dyn` needs it).
inline cudaError_t cooperative_grid(const void* kernel, int threads,
                                    size_t dyn, int* grid) {
  DeviceInfo info;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return err;
  if (!info.cooperative) return cudaErrorNotSupported;
  if (dyn > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dyn));
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      dyn);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = per_sm * info.sms;
  return cudaSuccess;
}

}  // namespace drain
