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
// writes 8 bytes per work unit.  The Pallas kernel counted `scan[j] <= k`
// over a [1024, W] tile (O(W) work per unit) because the TPU's vector unit
// has no per-lane gather.  Here the search is the load-balancing search of
// moderngpu and of Merrill and Garland's merge-based SpMV: the owners are
// the merge of the scan entries with the units 0 .. budget - 1, where
// scan[j] comes before unit k when scan[j] <= k (so a zero-degree chunk
// owns no unit, and an entry equal to k comes before unit k).
//
//   * The partition.  Block b takes merge items [b T, (b + 1) T) of the
//     budget + W, T = 2048.  Two warps find the merge path's split at the
//     tile's two ends by a 32-way search of the scan in global memory (L2),
//     three dependent probes at W = 4096.
//   * A window, not the whole scan.  The tile's scan entries, at most T,
//     are the only ones its block stages in shared memory: the blocks read
//     the scan once between them, however long the runs of zero-degree
//     chunks a tile crosses.
//   * Owners by a serial merge.  Each thread finds its own 8 items' split
//     in the window and walks them in order: no search per unit.  The
//     owners and ranks go through shared memory and out as coalesced
//     16-byte stores.
//   * Tiles past the total.  A tile wholly past scan[W - 1] holds units
//     only, each of owner W and rank k - total; it writes them without a
//     search or a window.  At coloring's flat budget that is most tiles.
//
// One launch, one tile a block, the grid sized to the budget plus W.
// `scan` must rise (an inclusive scan of degrees); on another input the
// values are unspecified, but no store leaves the two outputs.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kPerThread = 8;                    // merge items a thread
constexpr int kTile = kThreads * kPerThread;     // merge items a block

// Is scan entry i after unit d - 1 - i in the merge, i.e. is the split of
// diagonal d at most i?
__device__ __forceinline__ bool past(int scan_i, long long d, int i) {
  return scan_i > d - 1 - i;
}

// The split of diagonal d: the number of scan entries among the first d
// merge items, the first i in [max(0, d - budget), min(d, W)) with
// past(scan[i], d, i), else min(d, W).  A whole warp calls it; each step
// probes 32 positions of the scan in global memory, so a range of W takes
// ceil(log32 W) dependent loads.
__device__ int split_global(const int* __restrict__ scan, int w, int budget,
                            long long d) {
  int lo = static_cast<int>(max(0LL, d - budget));
  int hi = static_cast<int>(min(d, static_cast<long long>(w)));
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step + step - 1;
    const bool t = p >= hi || past(__ldg(scan + p), d, p);
    const unsigned ball = __ballot_sync(kFull, t);
    if (ball == 0u) {
      lo = hi;
    } else {
      const int f = __ffs(ball) - 1;
      hi = min(hi, lo + f * step + step - 1);
      lo = lo + f * step;
    }
  }
  return lo;
}

// Write units [k0, k1) of owner and rank, value(k, o, r) giving each: the
// unaligned head and tail one int a thread, the rest 16 bytes a thread.
template <class Value>
__device__ __forceinline__ void store_units(int* __restrict__ owner,
                                            int* __restrict__ rank, int k0,
                                            int k1, Value value) {
  const int tid = threadIdx.x;
  const int head = min(k1, (k0 + 3) & ~3);
  const int body = max(head, k1 & ~3);
  for (int k = k0 + tid; k < head; k += kThreads) value(k, owner[k], rank[k]);
  for (int q = head / 4 + tid; q < body / 4; q += kThreads) {
    int4 o, r;
    value(4 * q, o.x, r.x);
    value(4 * q + 1, o.y, r.y);
    value(4 * q + 2, o.z, r.z);
    value(4 * q + 3, o.w, r.w);
    reinterpret_cast<int4*>(owner)[q] = o;
    reinterpret_cast<int4*>(rank)[q] = r;
  }
  for (int k = body + tid; k < k1; k += kThreads) value(k, owner[k], rank[k]);
}

__global__ void __launch_bounds__(kThreads) lbs_merge(
    const int* __restrict__ scan, int w, int* __restrict__ owner,
    int* __restrict__ rank, int budget) {
  __shared__ int s_scan[kTile + 1];  // scan[a0 - 1 .. a1), 0 before entry 0
  __shared__ int s_owner[kTile];
  __shared__ int s_rank[kTile];
  __shared__ int s_split[2];
  const int tid = threadIdx.x;
  const long long d0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long d1 =
      min(d0 + kTile, static_cast<long long>(budget) + w);
  const int total = w > 0 ? max(__ldg(scan + w - 1), 0) : 0;

  // a tile past the total: every scan entry comes before its units
  if (d0 >= static_cast<long long>(w) + total) {
    store_units(owner, rank, static_cast<int>(d0 - w),
                static_cast<int>(d1 - w), [&](int k, int& o, int& r) {
                  o = w;
                  r = k - total;
                });
    return;
  }

  const int warp = tid >> 5;
  if (warp < 2) {
    const int a = split_global(scan, w, budget, warp == 0 ? d0 : d1);
    if ((tid & 31) == 0) s_split[warp] = a;
  }
  __syncthreads();
  const int a0 = s_split[0];
  // on a scan that rises the splits rise and a1 - a0 <= d1 - d0; the
  // clamp keeps every index inside the tile on any other input
  const int a1 = min(max(s_split[1], a0), a0 + static_cast<int>(d1 - d0));
  const int b0 = static_cast<int>(d0 - a0);
  const int b1 = static_cast<int>(d1 - a1);
  for (int i = tid; i <= a1 - a0; i += kThreads) {
    const int j = a0 - 1 + i;
    s_scan[i] = j >= 0 ? __ldg(scan + j) : 0;
  }
  __syncthreads();

  // this thread's split in the window, then its items in merge order
  const long long d = d0 + min(tid * kPerThread, static_cast<int>(d1 - d0));
  int lo = max(a0, static_cast<int>(max(d - b1, 0LL)));
  int hi = min(a1, static_cast<int>(d - b0));
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (past(s_scan[1 + mid - a0], d, mid)) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  int a = lo;
  int b = static_cast<int>(d - a);
  const int items = static_cast<int>(min(static_cast<long long>(kPerThread),
                                         d1 - d));
  for (int i = 0; i < items; ++i) {
    if (a < a1 && (b >= b1 || s_scan[1 + a - a0] <= b)) {
      ++a;
    } else if (b < b1) {
      s_owner[b - b0] = a;
      s_rank[b - b0] = b - s_scan[a - a0];
      ++b;
    }
  }
  __syncthreads();
  store_units(owner, rank, b0, b1, [&](int k, int& o, int& r) {
    o = s_owner[k - b0];
    r = s_rank[k - b0];
  });
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 on success).
extern "C" int lbs_launch(const int* scan, int w, int* owner, int* rank,
                          int budget, cudaStream_t stream) {
  if (w < 0 || budget < 0) return cudaErrorInvalidValue;
  if (budget == 0) return cudaSuccess;
  const long long blocks =
      (static_cast<long long>(budget) + w + kTile - 1) / kTile;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  lbs_merge<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      scan, w, owner, rank, budget);
  return cudaGetLastError();
}
