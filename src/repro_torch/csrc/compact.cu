// Stable stream compaction, kernel B2: the task queue's push-slot reservation.
//
// Replaces the TPU kernel `compact_tiles_pallas` (body `_compact_kernel`) in
// src/repro/kernels/queue_compact/kernel.py together with its phase-2 stitch
// in src/repro/kernels/queue_compact/ops.py `compact`.  For items[N] and
// mask[N] it writes
//
//   out[0 : count] = the items whose mask is set, in index order
//   out[count : N] = 0
//   *count         = the number of such items (left on the device)
//
// bit-equal to the prefix-sum reference `compact_ref`.
//
// What bounds it on an H100: bytes.  It reads N * 5 bytes (int32 items,
// bool mask) and writes N * 4; there is no arithmetic to speak of.  The
// Pallas kernel compacted each 256-item tile by a one-hot [256, 256]
// contraction, because the TPU's vector unit has no scatter, and its
// sequential grid handed each tile its offset.  Here blocks run in any
// order, so the reservation takes three launches on one stream:
//
//   1. tile_counts:  each block counts its tile's kept items with
//                    __ballot_sync / __popc (one ballot per warp per pass);
//   2. scan_counts:  one block turns the tile counts into exclusive tile
//                    offsets, in place, and writes the total to *count;
//   3. scatter_kept: each block recomputes its ballots, writes every kept
//                    item to tile offset + rank within the tile, and zeroes
//                    its positions at or past *count.
//
// Every rank comes from a prefix sum, never from an atomic ticket, so the
// output is stable; the queue buffer built from it is bit-identical to the
// reference's.  The mask is read twice (passes 1 and 3); a single-pass
// decoupled look-back would read it once and is left for later.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPasses = 4;
constexpr int kTile = kThreads * kPasses;      // items per block
constexpr int kScanThreads = 1024;

__global__ void tile_counts(const bool* __restrict__ mask, int n,
                            int* __restrict__ counts) {
  __shared__ int warp_sum[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kTile;
  int c = 0;
  for (int p = 0; p < kPasses; ++p) {
    const int i = base + p * kThreads + threadIdx.x;
    const bool keep = i < n && mask[i];
    c += __popc(__ballot_sync(0xffffffffu, keep));
  }
  if (lane == 0) warp_sum[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_sum[w];
    counts[blockIdx.x] = s;
  }
}

// One block of kScanThreads: each thread sums a contiguous run of tile
// counts, the block scans the run sums, and each thread writes its run's
// exclusive offsets back in place.
__global__ void scan_counts(int* __restrict__ counts, int nb,
                            int* __restrict__ total) {
  __shared__ int sums[kScanThreads];
  const int per = (nb + kScanThreads - 1) / kScanThreads;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < nb ? lo + per : nb;
  int s = 0;
  for (int i = lo; i < hi; ++i) s += counts[i];
  sums[threadIdx.x] = s;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int v = threadIdx.x >= off ? sums[threadIdx.x - off] : 0;
    __syncthreads();
    sums[threadIdx.x] += v;
    __syncthreads();
  }
  int run = threadIdx.x > 0 ? sums[threadIdx.x - 1] : 0;
  for (int i = lo; i < hi; ++i) {
    const int c = counts[i];
    counts[i] = run;
    run += c;
  }
  if (threadIdx.x == kScanThreads - 1) *total = sums[kScanThreads - 1];
}

__global__ void scatter_kept(const int* __restrict__ items,
                             const bool* __restrict__ mask, int n,
                             const int* __restrict__ offsets,
                             const int* __restrict__ total,
                             int* __restrict__ out) {
  __shared__ int warp_cnt[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int base = blockIdx.x * kTile;
  const int count = *total;
  int run = offsets[blockIdx.x];
  for (int p = 0; p < kPasses; ++p) {
    const int i = base + p * kThreads + threadIdx.x;
    const bool keep = i < n && mask[i];
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_cnt[warp] = __popc(ballot);
    __syncthreads();
    int before = run;
    int pass_total = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_cnt[w] : 0;
      pass_total += warp_cnt[w];
    }
    if (keep) out[before + __popc(ballot & below)] = items[i];
    if (i < n && i >= count) out[i] = 0;
    run += pass_total;
    __syncthreads();  // warp_cnt is rewritten by the next pass
  }
}

}  // namespace

// `tile_scratch` holds ceil(n / kTile) ints.  Launches on `stream`; returns
// the cudaError_t of the launches (0 on success).
extern "C" int compact_launch(const int* items, const bool* mask, int n,
                              int* out, int* count, int* tile_scratch,
                              cudaStream_t stream) {
  const int nb = (n + kTile - 1) / kTile;
  tile_counts<<<nb, kThreads, 0, stream>>>(mask, n, tile_scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_counts<<<1, kScanThreads, 0, stream>>>(tile_scratch, nb, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scatter_kept<<<nb, kThreads, 0, stream>>>(items, mask, n, tile_scratch,
                                            count, out);
  return cudaGetLastError();
}

// Items per block, so that the caller sizes `tile_scratch`.
extern "C" int compact_tile() { return kTile; }
