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
//   * grid_barrier: one arrival word in device memory (no -rdc build),
//     flipped by the top-bit count of cooperative groups' grid sync; a
//     barrier that has not completed after about half a minute traps, so a
//     fault ends the launch with an error instead of holding the card;
//   * block-wide exclusive scans and sums, the inclusive scan of a
//     wavefront spread over the block's threads, and scan_lanes, the
//     inclusive scan of a wavefront's lanes in shared memory (B3-BFS,
//     B3-col);
//   * upper_bound over a scan: kernel B1's search;
//   * ring_push: the round's push into the task ring at tail + rank, the
//     ranks from prefix sums (never an atomic ticket), so the ring is
//     bit-identical to TaskQueue.push; what exceeds the free slots is
//     dropped;
//   * the fused mode (B3-fused): the task ring is lane 0 of the fused
//     topology's MultiQueue, whose words are (job << 24) | zigzag(task)
//     with job 0 (server/encoding.py); lane_load unpacks a popped word and
//     lane_store packs a pushed task, the identity in the single mode;
//   * the traced mode (B3-traced): one row of obs/schema.TRACE_FIELDS a
//     round into a TraceRing, written by block 0 after the round's last
//     grid barrier;
//   * cooperative_grid: the co-resident grid of a kernel;
//   * chunk tasks (core/task.py): the codec, a chunk's degree, the member
//     row of a unit (chunk_row_of), and the in-kernel coalesce_chunks over
//     G-aligned windows whose words are stamped with the round;
//   * the slotted mode (B3-slotted): the neighbors of a streaming graph's
//     slotted view (graph/slotted.py), a row's slab prefix and then its
//     overlay tail, read in place of a canonical col_idx word.
//
// Values that other blocks write inside the launch are read with
// ld.global.cg (__ldcg), past the SM's incoherent L1.
#pragma once

#include <cuda_pipeline.h>
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

// The grid barrier.  One arrival word, zero at launch and never reset:
// after the block's __syncthreads(), its thread 0 adds 1 to the word, or
// 2^31 - (G - 1) in block 0, with release semantics at gpu scope, so the
// G adds of one barrier sum to 2^31 and the word's top bit flips when the
// last block arrives (the count of cooperative groups' grid sync).  Thread
// 0 then spins on acquire loads at gpu scope until the top bit differs
// from the one its add returned, and a second __syncthreads() releases the
// block.  A block that runs ahead into the next barrier adds without
// flipping the bit, as the next flip needs every block.  The release and
// the acquire, with the block barriers around them, order every thread's
// writes before the barrier ahead of every read after it, so no thread
// fences on its own; data that other blocks write is still read with
// __ldcg, past the SM's L1.  Thread 0 polls without a nap: a 64 ns nap
// measured slower at one and at two blocks an SM.
constexpr long long kSpinCycles = 1ll << 36;  // about 35 s at 1.98 GHz

__device__ __forceinline__ unsigned add_release_gpu(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.release.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ unsigned load_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ inline void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1u)
                                         : 1u;
    const unsigned old = add_release_gpu(bar, add);
    const long long start = clock64();
    while (((load_acquire_gpu(bar) ^ old) & 0x80000000u) == 0u) {
      if (clock64() - start > kSpinCycles) __trap();
    }
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

// In place, the int32 inclusive scan of s[0 : n] by the block, a
// wavefront's lanes in shared memory (B3-BFS, B3-col).  Each warp scans a
// contiguous segment, kScanGroup runs of 32 words at a time with
// neighbouring lanes on neighbouring words (no bank conflicts), the runs'
// warp scans interleaved and joined by their totals; a segment of one
// group stays in registers until the warps' totals are joined.  Every
// thread of the block must call it; it ends with the block synchronized.
// On an H100 the interleaving made B3-BFS's drains 2.9-4.7 % and B3-col's
// 1.1-1.4 % faster than one run at a time (PERF.md).
constexpr int kScanGroup = 8;

template <int kThreads>
__device__ void scan_lanes(int* s, int n, int* warp_sums) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = ((n + kWarps - 1) / kWarps + 31) & ~31;
  const int lo = min(warp * per, n);
  const int hi = min(lo + per, n);
  unsigned carry = 0u;
  unsigned x[kScanGroup] = {};
  for (int b = lo; b < hi; b += 32 * kScanGroup) {
#pragma unroll
    for (int i = 0; i < kScanGroup; ++i) {
      const int at = b + 32 * i + lane;
      x[i] = at < hi ? static_cast<unsigned>(s[at]) : 0u;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < kScanGroup; ++i) {
        const unsigned y = __shfl_up_sync(kFull, x[i], off);
        if (lane >= off) x[i] += y;
      }
    }
#pragma unroll
    for (int i = 0; i < kScanGroup; ++i) {
      const unsigned total = __shfl_sync(kFull, x[i], 31);
      x[i] += carry;
      carry += total;
    }
    if (per > 32 * kScanGroup) {
#pragma unroll
      for (int i = 0; i < kScanGroup; ++i) {
        const int at = b + 32 * i + lane;
        if (at < hi) s[at] = static_cast<int>(x[i]);
      }
    }
  }
  if (lane == 0) warp_sums[warp] = static_cast<int>(carry);
  __syncthreads();
  unsigned before = 0u;
  for (int w = 0; w < warp; ++w) before += static_cast<unsigned>(warp_sums[w]);
  if (per <= 32 * kScanGroup) {
#pragma unroll
    for (int i = 0; i < kScanGroup; ++i) {
      const int at = lo + 32 * i + lane;
      if (at < hi) s[at] = static_cast<int>(x[i] + before);
    }
  } else {
    for (int i = lo + lane; i < hi && before; i += 32) {
      s[i] = static_cast<int>(static_cast<unsigned>(s[i]) + before);
    }
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

// ----------------------------------------------------------- packed lanes
// A fused lane's word is (job << kPayloadBits) | (zigzag(task) & mask), job 0
// here, as server/encoding.pack writes it; int32 shifts wrap and >> is
// arithmetic, as torch's are.  A task whose zigzag needs more than 24 bits
// would not survive: the wrapper's admission (check_job_fits at the
// config's granularity) keeps every task inside.
constexpr int kPayloadBits = 24;
constexpr int kPayloadMask = (1 << kPayloadBits) - 1;

__device__ __forceinline__ int zigzag(int t) {
  return static_cast<int>(static_cast<unsigned>(t) << 1) ^ (t >> 31);
}

__device__ __forceinline__ int unzigzag(int z) { return (z >> 1) ^ -(z & 1); }

// The task of a popped ring word, and the ring word of a pushed task.
template <bool kPacked>
__device__ __forceinline__ int lane_load(int word) {
  return kPacked ? unzigzag(word & kPayloadMask) : word;
}

template <bool kPacked>
__device__ __forceinline__ int lane_store(int task) {
  return kPacked ? (zigzag(task) & kPayloadMask) : task;
}

// What ring_push does after each write by default: nothing.
struct NoWrite {
  __device__ __forceinline__ void operator()(int, int) const {}
};

// The round's push.  Each block has written how many positions of its range
// [lo, hi) it keeps into block_count[blockIdx.x], and a grid barrier has
// passed since.  `item(p, value)` says whether position p is kept and sets
// its task.  Writes the kept tasks of [lo, hi), in position order, into the
// ring at tail + (kept positions before them), packed in the fused mode,
// and calls written(rank, task) after each; a write at or past
// `free_slots` is dropped.  Returns the round's kept count (every block gets
// it).  Every thread of the block must call it.
template <int kThreads, bool kPacked, class Item, class Written = NoWrite>
__device__ int ring_push(int* buf, int cap, int tail, int free_slots,
                         const int* block_count, int lo, int hi,
                         int* warp_sums, Item item,
                         Written written = Written()) {
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
    if (keep && r < free_slots) {
      buf[ring_slot(wrap_add(tail, r), cap)] = lane_store<kPacked>(value);
      written(r, value);
    }
    offset = wrap_add(offset, tile_total);
  }
  return count;
}

// ---------------------------------------------------------------- chunks
// A task is a chunk of `width` consecutive CSR rows from `head`, packed as
// (head << bits) | (width - 1) with bits = ceil(log2 G) (core/task.py).  At
// G = 1 bits is 0 and a task is its vertex.  Not every code is a legal width
// when G is not a power of two; the decode is the plain one all the same.
struct Codec {
  int G;     // the granularity, 1..64
  int bits;  // ceil(log2 G)
};

__device__ __forceinline__ int chunk_head(int task, Codec c) {
  return task >> c.bits;  // arithmetic, as torch's >> on int32
}

__device__ __forceinline__ int chunk_width(int task, Codec c) {
  return (task & ((1 << c.bits) - 1)) + 1;
}

__device__ __forceinline__ int chunk_encode(int v, int width, Codec c) {
  return static_cast<int>((static_cast<unsigned>(v) << c.bits) |
                          (static_cast<unsigned>(width - 1) &
                           ((1u << c.bits) - 1u)));
}

// rp[min(head + width, n)] - rp[head], both ends clamped into [0, n] as
// core/frontier.chunk_degrees clamps them.
__device__ __forceinline__ int chunk_degree(const int* rp, int head,
                                            int width, int n) {
  const int lo = clamp_to(head, 0, n);
  const int hi = clamp_to(wrap_add(lo, width), 0, n);
  return wrap_sub(__ldg(rp + hi), __ldg(rp + lo));
}

// The member row of the unit at offset `rank` inside the chunk [head,
// head + width): head plus the number of j in [1, width) with
// rp[head + j] - rp[head] <= rank -- the last such j, since rp rises -- the
// compare-count of core/frontier.chunk_row_of, clamped into [0, n - 1].
// A member row of degree 0 adds its j only where the next row's offset
// does too, so it is skipped exactly as the compare-count skips it.
__device__ __forceinline__ int chunk_row_of(const int* rp, int head, int rank,
                                            int width, int n) {
  const int base = __ldg(rp + head);
  int local = 0;
  for (int j = 1; j < width; ++j) {
    local += wrap_sub(__ldg(rp + clamp_to(head + j, 0, n)), base) <= rank;
  }
  return clamp_to(head + local, 0, n > 0 ? n - 1 : 0);
}

// In-kernel core/task.coalesce_chunks.  The marked vertex ids of a round
// are gathered per G-aligned window v / G: the count, the least and the
// largest id.  A window whose ids are contiguous (vmax - vmin + 1 == cnt)
// and whose degree sum rp[vmin + cnt] - rp[vmin] is at most the split
// threshold forms one chunk of width cnt on the lane that holds vmin; its
// other lanes push nothing; every lane of any other window pushes a
// width-1 chunk.  The marked ids of one round are distinct in every caller
// (a BFS neighbor kept once by the dedup, a PageRank rescan window of at
// most n consecutive ids, coloring's disjoint chunks), so the lane of vmin
// is the window's one lane, and it counts the window as split when it is
// contiguous, holds more than one id and does not fit.
//
// The three words of a window are 64-bit, the round's stamp r (rounds + 1,
// rising) in the high half: every update is an atomicMax, which replaces a
// word of an older round outright, so no word is ever reset and the arrays
// need only be zero at launch.  The count is atomicMax(r << 32) then
// atomicAdd(1); the least id is kept as the largest ~v.  Cost: the three
// atomics a marked lane, one grid barrier between them and the reads, and
// 24 bytes a window.
struct Windows {
  unsigned long long* cnt;   // [n / G + 2] (r << 32) | count
  unsigned long long* vmin;  // [n / G + 2] (r << 32) | ~least id
  unsigned long long* vmax;  // [n / G + 2] (r << 32) | largest id
  unsigned int* splits;      // [1] the windows split, summed over the drain
  const int* rp;             // the formation row_ptr [n + 1]
  int n;
  int threshold;             // the split threshold; INT_MAX when none
};

__device__ __forceinline__ void window_add(const Windows& w, int v, Codec c,
                                           unsigned r) {
  const int b = v / c.G;
  const unsigned long long hi = static_cast<unsigned long long>(r) << 32;
  atomicMax(w.cnt + b, hi);
  atomicAdd(w.cnt + b, 1ull);
  atomicMax(w.vmin + b, hi | static_cast<unsigned>(~static_cast<unsigned>(v)));
  atomicMax(w.vmax + b, hi | static_cast<unsigned>(v));
}

// The task that marked vertex v pushes after the window_add of every marked
// lane of the round (a grid barrier between), or -1 when it pushes none.
// `count_split` adds the window to the split count: pass it on one pass
// over the lanes only.
__device__ __forceinline__ int window_emit(const Windows& w, int v, Codec c,
                                           bool count_split) {
  const int b = v / c.G;
  const int cnt = static_cast<int>(__ldcg(w.cnt + b) & 0xffffffffull);
  const int vmn = static_cast<int>(
      ~static_cast<unsigned>(__ldcg(w.vmin + b) & 0xffffffffull));
  const int vmx = static_cast<int>(__ldcg(w.vmax + b) & 0xffffffffull);
  const bool contiguous = wrap_add(wrap_sub(vmx, vmn), 1) == cnt;
  const int head = clamp_to(vmn, 0, w.n > 0 ? w.n - 1 : 0);
  const int degsum = wrap_sub(
      __ldg(w.rp + clamp_to(wrap_add(vmn, cnt), 0, w.n)), __ldg(w.rp + head));
  const bool fits = degsum <= w.threshold;
  if (contiguous && fits) return v == vmn ? chunk_encode(v, cnt, c) : -1;
  if (count_split && v == vmn && contiguous && cnt > 1) atomicAdd(w.splits, 1u);
  return chunk_encode(v, 1, c);
}

// --------------------------------------------------------- slotted mode
// A streaming graph's slotted view (graph/slotted.SlottedView): the kernel's
// column array is the slab array, and the word at in-row offset `off` of row
// r is slab_col[slab_ptr[r] + off] while off < slab_len[r], and
// ovl_col[ovl_ptr[r] + off - slab_len[r]] past it (core/frontier.
// gather_neighbors' two-level read).  row_ptr stays the canonical degree
// prefix sum, so the scans, budgets, chunk codes and searches are the
// canonical mode's; only the word a unit reads changes.  A unit of the
// merge-path layout has off < deg(r), so both reads are in range.  The
// reference streams each chunk's slab span and reads the overlay from its
// flat array (src/repro/kernels/drain_loop/csr_stream.py:147-171); here
// each unit reads its own word, which computes the same.
struct Slotted {
  const int* slab_ptr;  // [n + 1]
  const int* slab_len;  // [n]
  const int* ovl_ptr;   // [n + 1]
  const int* ovl_col;   // [>= 1]
};

// The word at in-row offset `off` of row r of a slotted view whose slab
// array is `slab_col`.
__device__ __forceinline__ int slotted_word(const Slotted& s,
                                            const int* __restrict__ slab_col,
                                            int r, int off) {
  const int len = __ldg(s.slab_len + r);
  return off < len ? __ldg(slab_col + __ldg(s.slab_ptr + r) + off)
                   : __ldg(s.ovl_col + __ldg(s.ovl_ptr + r) + (off - len));
}

// Stage that word into `dst`, a word of a stream stage (csr_stream.cuh): a
// slab word by cp.async, an overlay word by a plain load and store, which
// the stage's wait orders before the word is read.
__device__ __forceinline__ void stage_slotted(int* dst, const Slotted& s,
                                              const int* __restrict__ slab_col,
                                              int r, int off) {
  const int len = __ldg(s.slab_len + r);
  if (off < len) {
    __pipeline_memcpy_async(dst, slab_col + __ldg(s.slab_ptr + r) + off,
                            sizeof(int));
  } else {
    *dst = __ldg(s.ovl_col + __ldg(s.ovl_ptr + r) + (off - len));
  }
}

// ------------------------------------------------------------ trace ring
// obs/ring.TraceRing: a [capacity][13] int32 ring of obs/schema.TRACE_FIELDS
// rows and its monotone cursor.  runtime/api.instrument_step defines the
// row: round, lane (0), the queue size before the pop, pops, pushes, the
// WorkCounter's work and splits deltas, and zeros in the sharded columns.
constexpr int kTraceFields = 13;

struct TraceRing {
  int* buf;  // [capacity][kTraceFields]; null in an untraced launch
  int capacity;
  int* cursor;  // [1] rows ever written, read at launch, written back
};

// One round's row at cursor % capacity.  Block 0's thread 0 calls it after
// the round's last grid barrier, from values every block holds.
__device__ inline void trace_row(const TraceRing& t, int cursor, int round,
                                 int queue_size, int pops, int pushes,
                                 int work, int splits) {
  int* row = t.buf + static_cast<size_t>(py_mod(cursor, t.capacity)) *
                         kTraceFields;
  const int values[7] = {round, 0, queue_size, pops, pushes, work, splits};
  for (int f = 0; f < kTraceFields; ++f) row[f] = f < 7 ? values[f] : 0;
}

// What the traced mode keeps in block 0's thread 0: the ring cursor and the
// drain's split count at the last row.  At kTraced = false every call is
// empty, so an untraced instance holds no ring code.
template <bool kTraced>
struct Tracer {
  int cursor = 0;
  int splits_seen = 0;

  static __device__ __forceinline__ bool writer() {
    return kTraced && blockIdx.x == 0 && threadIdx.x == 0;
  }
  // At launch, before the first grid barrier.
  __device__ __forceinline__ void begin(const TraceRing& t) {
    if (writer()) cursor = *t.cursor;
  }
  // After the round's last grid barrier: `splits` is the drain's split
  // word (its atomics all precede that barrier), or null at G = 1.
  __device__ __forceinline__ void record(const TraceRing& t,
                                         const unsigned int* splits,
                                         int round, int queue_size,
                                         int pops, int pushes, int work) {
    if (!writer()) return;
    int delta = 0;
    if (splits) {
      const int now = static_cast<int>(__ldcg(splits));
      delta = wrap_sub(now, splits_seen);
      splits_seen = now;
    }
    trace_row(t, cursor, round, queue_size, pops, pushes, work, delta);
    cursor = wrap_add(cursor, 1);
  }
  // At the end, with the other cursors.
  __device__ __forceinline__ void end(const TraceRing& t) {
    if (writer()) *t.cursor = cursor;
  }
};

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
  // opt in whenever there is dynamic shared memory: static and dynamic
  // together may pass the 48 KB a block gets without it
  if (dyn > 0) {
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
