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
// order, and one launch does it all in a single pass over the input, with
// decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", 2016):
//
//   * a block takes its tile id from an atomic ticket, not blockIdx, so a
//     tile's predecessors have all started (they run or have finished);
//     while the ticket is out it loads the tile of its own index, which is
//     mostly the one it draws, and loads again when it is not;
//   * it loads its 4096 items and mask bytes once (8 a thread, in vector
//     loads), and ranks the kept ones by a block-wide scan;
//   * it publishes its kept count (flag A), then warp 0 looks back over
//     its predecessors' status words, 32 at a time, summing A counts up to
//     the nearest inclusive prefix (flag P), and publishes its own P;
//   * it writes its kept items at prefix + rank.
//
// A status word is (flag, value) in 64 bits, stored whole; flag 0 means
// not yet published.  The wrapper zeroes the words, the ticket, the
// output and the count in one allocation before the launch, so every word
// starts unpublished and every position past count is already 0: the
// kernel writes only the kept items, and no write of one tile can race
// with another's.  A call is that fill and this launch: zeroing past
// count inside the kernel needs tiles to wait on earlier tiles' zeros,
// and measured slower on an H100 at the push's shape.

#include <cuda_runtime.h>

#include "drain_common.cuh"

namespace {

using drain::block_exclusive_scan;
using drain::kFull;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                  // contiguous items a thread
constexpr int kTile = kThreads * kItems;   // items a block
// a wait on an earlier tile that has not published after this many polls
// (a fault: every earlier tile runs) traps instead of holding the card
constexpr unsigned kSpinLimit = 1u << 24;
constexpr unsigned kAggregate = 1;
constexpr unsigned kPrefix = 2;

typedef unsigned long long Word;

__device__ __forceinline__ Word status_word(unsigned flag, int value) {
  return (static_cast<Word>(flag) << 32) | static_cast<unsigned>(value);
}

__device__ __forceinline__ Word load_word(const Word* p) {
  return *reinterpret_cast<const volatile Word*>(p);
}

__device__ __forceinline__ void store_word(Word* p, Word w) {
  *reinterpret_cast<volatile Word*>(p) = w;
}

// By warp 0 of tile `tile` > 0: the count of kept items in all tiles before
// it, from their status words (every lane gets it).
__device__ int look_back(const Word* status, int tile) {
  const int lane = threadIdx.x & 31;
  int exclusive = 0;
  for (int pos = tile - 1;; pos -= 32) {
    const int at = pos - lane;
    unsigned flag = kPrefix;  // before tile 0: a prefix of 0
    int value = 0;
    if (at >= 0) {
      Word w = load_word(status + at);
      unsigned spins = 0;
      while ((w >> 32) == 0) {
        if (++spins > kSpinLimit) __trap();
        w = load_word(status + at);
      }
      flag = static_cast<unsigned>(w >> 32);
      value = static_cast<int>(static_cast<unsigned>(w));
    }
    const unsigned prefixes = __ballot_sync(kFull, flag == kPrefix);
    // the nearest prefix is the lowest lane holding one; lanes past it are
    // earlier tiles that the prefix already counts
    const int last = prefixes ? __ffs(prefixes) - 1 : 31;
    int sum = lane <= last ? value : 0;
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(kFull, sum, off);
    }
    exclusive += sum;
    if (prefixes) return exclusive;
  }
}

// This thread's kItems items of tile `tile` into v, and which of them are
// kept, a bit each.
__device__ __forceinline__ unsigned load_tile(const int* __restrict__ items,
                                              const unsigned char* __restrict__ mask,
                                              int n, bool aligned, int tile,
                                              int* v) {
  const int first = tile * kTile + threadIdx.x * kItems;
  unsigned keep = 0;
  if (aligned && first + kItems <= n) {
    const uint2 m = *reinterpret_cast<const uint2*>(mask + first);
    const int4 a = *reinterpret_cast<const int4*>(items + first);
    const int4 b = *reinterpret_cast<const int4*>(items + first + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      keep |= (((m.x >> (8 * j)) & 0xffu) != 0u) << j;
      keep |= (((m.y >> (8 * j)) & 0xffu) != 0u) << (j + 4);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = first + j;
      v[j] = 0;
      if (i < n && mask[i]) {
        keep |= 1u << j;
        v[j] = items[i];
      }
    }
  }
  return keep;
}

__global__ void __launch_bounds__(kThreads) compact_one_pass(
    const int* __restrict__ items, const unsigned char* __restrict__ mask,
    int n, bool aligned, int* __restrict__ out, int* __restrict__ count,
    Word* status, unsigned* ticket) {
  __shared__ int warp_sums[kWarps];
  __shared__ int shared_tile;
  __shared__ int shared_prefix;
  const int tid = threadIdx.x;
  const int tiles = gridDim.x;
  if (tid == 0) {
    shared_tile = static_cast<int>(atomicAdd(ticket, 1u));
  }
  // blocks mostly draw their own index: load that tile while the ticket is
  // out, and load again if the draw says otherwise
  int v[kItems];
  unsigned keep = load_tile(items, mask, n, aligned, blockIdx.x, v);
  __syncthreads();
  const int tile = shared_tile;
  if (tile != static_cast<int>(blockIdx.x)) {
    keep = load_tile(items, mask, n, aligned, tile, v);
  }
  int total;
  const int rank =
      block_exclusive_scan<kThreads>(__popc(keep), warp_sums, total);

  if (tid < 32) {
    int prefix = 0;
    if (tile == 0) {
      if (tid == 0) store_word(status, status_word(kPrefix, total));
    } else {
      if (tid == 0) {
        store_word(status + tile, status_word(kAggregate, total));
      }
      prefix = look_back(status, tile);
      if (tid == 0) {
        store_word(status + tile,
                   status_word(kPrefix, prefix + total));
      }
    }
    if (tid == 0) shared_prefix = prefix;
  }
  __syncthreads();
  int at = shared_prefix + rank;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if ((keep >> j) & 1u) out[at++] = v[j];
  }
  if (tile == tiles - 1 && tid == 0) *count = shared_prefix + total;
}

}  // namespace

// `status` holds a word per tile (compact_tile() items) and `ticket` one
// word, all zero, as is `out`.  `aligned`: items on 16 bytes and mask on
// 8.  Launches on `stream`; returns the cudaError_t of the launch (0 on
// success).
extern "C" int compact_launch(const int* items, const bool* mask, int n,
                              bool aligned, int* out, int* count,
                              unsigned long long* status, unsigned* ticket,
                              cudaStream_t stream) {
  const int tiles = (n + kTile - 1) / kTile;
  compact_one_pass<<<tiles, kThreads, 0, stream>>>(
      items, reinterpret_cast<const unsigned char*>(mask), n, aligned, out,
      count, status, ticket);
  return cudaGetLastError();
}

// Items per block, so that the caller sizes the status words.
extern "C" int compact_tile() { return kTile; }
