// The ordered scatter-add: PageRank's deterministic `.at[].add`.
//
// Replaces no TPU kernel.  `residue.at[nbr].add(contrib)` in
// src/repro/algorithms/pagerank.py:122 runs on XLA's CPU backend as a loop
// over the updates in order, so each slot gets ((r + c1) + c2) + ... in
// update order.  Atomics on the card add in an order that changes from run
// to run, and float addition does not associate, so the low bits of the
// ranks would change with it.  This kernel adds in update order:
//
//   out = base;  out[index[u]] += values[u]  for u = 0, 1, ..., k - 1
//
// bit-equal to the CPU's sequential sum.  The float64 instance serves the
// streaming PageRank rule's sums (stream/incremental.py), numpy's
// `bincount(index, weights)` when `base` holds zeros.
//
// The design is the segment sort of B3-pr's ordered sum (pagerank_drain.cu,
// step 6), as launches of their own over k updates into n slots; no library
// sort and no separate copy.  Four launches on one stream:
//
//   1. count    place[u] = atomicAdd(&seg_count[index[u]], 1): the update's
//               arbitrary place in its index's segment.  The same launch
//               copies base into out.
//   2. reserve  each update with place 0 reserves its index's segment: a
//               block scans the lengths of its place-0 updates and takes one
//               atomic on a cursor for them all, and writes each segment's
//               (start, length).  A segment of one update is added here at
//               once; the others are listed by length: for a thread (up to
//               8), a warp (up to 256), a block (up to 2048) or the merge
//               tier (longer).
//   3. place    every update of a listed segment writes its record (u,
//               values[u]) at start + place.
//   4. sum      each listed segment is sorted by u and added left to right
//               onto out[index], and its count set back to 0:
//               * up to 8 entries by one thread, in registers;
//               * up to 64 by one warp ranking each entry by shuffles;
//               * up to 256 by one warp: a bitonic network over 8 entries a
//                 lane, register swaps within a lane and shuffles across;
//               * up to 2048 by one block: the warps sort 256 each, rounds
//                 of merges in shared memory double the sorted runs
//                 (merge path); while the queue has more, the block writes
//                 the sorted values back and its threads later add such
//                 segments side by side, one a thread;
//               * longer, the merge tier: runs of 2048 sorted as above,
//                 then log2(L / 2048) passes merging pairs of runs in
//                 global memory (so O(L log L) for a segment of L), a tile
//                 of 2048 outputs staged in shared memory at a time, then
//                 one thread adds through shared memory, one half loading
//                 while it adds the other.  Each run, tile and add is an
//                 item of a queue that the blocks take in turn, stage by
//                 stage over all such segments, so one long segment is
//                 sorted by many blocks at once.
//
// Reserve and place are separate launches: an update's segment may be
// reserved by another block, and in a plain launch that block may never be
// resident while this one waits.  Sum is one too: a segment is whole only
// when every update has placed its record.  Inside sum an item of the
// merge tier waits for the stage before it of its own segment, whose items
// stand earlier in the queue: blocks that run took them, and none of those
// waits on a later item.  Every count returns to 0 as its segment is
// added, so seg_count (n words) is zero on entry without a memset per
// call.  No result depends on timing: atomics only choose where a record
// sits and which block or thread sums which segment, never the order of a
// sum.  (One cooperative launch with a grid barrier between the passes
// measured slower than separate launches, and closing a segment in the
// place launch by its last update to arrive slower still: the segments
// closed last piled onto the last blocks; PERF.md §6.)
//
// What bounds it on an H100: bytes.  The least traffic reads base and
// writes out (8 bytes a slot in float32) and reads each update's index and
// value (8 bytes); the passes add the places (8 bytes an update), a record
// written and read (16; 32 in float64) and a gather of seg_count and the
// segment's (start, length) per update.  The sum of one segment is a chain
// of dependent adds in update order that no design removes: the longest
// segment sets a floor (at rmat(21)'s largest in-degree, 102,430 float64
// adds).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "drain_common.cuh"

namespace {

using drain::block_exclusive_scan;
using drain::kFull;

constexpr int kThreads = 256;
constexpr int kReservePer = 4;  // updates a thread reserves for
constexpr unsigned kReserveTile = kThreads * kReservePer;
// the tiers by segment length
constexpr int kThreadSort = 8;
constexpr int kWarpRank = 64;
constexpr int kWarpSort = 256;  // 8 entries a lane
constexpr int kBlockSort = 2048;
constexpr int kHalf = kBlockSort / 2;

// A segment's entry: the update's id and its value, stored and loaded whole.
template <class T>
struct Record;
template <>
struct __align__(8) Record<float> {
  int id;
  float v;
};
template <>
struct __align__(16) Record<double> {
  int id;
  int pad;
  double v;
};

__device__ __forceinline__ void store_record(Record<float>* p, int id,
                                             float v) {
  *reinterpret_cast<int2*>(p) = make_int2(id, __float_as_int(v));
}

__device__ __forceinline__ void store_record(Record<double>* p, int id,
                                             double v) {
  *reinterpret_cast<int4*>(p) =
      make_int4(id, 0, __double2loint(v), __double2hiint(v));
}

// Records are read through L2: other threads wrote them in this launch,
// past the SM's incoherent L1.
__device__ __forceinline__ Record<float> load_record(const Record<float>* p) {
  const int2 x = __ldcg(reinterpret_cast<const int2*>(p));
  return Record<float>{x.x, __int_as_float(x.y)};
}

__device__ __forceinline__ Record<double> load_record(
    const Record<double>* p) {
  const int4 x = __ldcg(reinterpret_cast<const int4*>(p));
  return Record<double>{x.x, 0, __hiloint2double(x.w, x.z)};
}

// The words before seg_count: the reserve cursor, the lengths of the lists
// of segments to sum (by thread, by warp; the merge tier's and the block
// tier's, on the long list), the merge tier's runs and most passes, the
// sum launch's queue and its finished blocks.  Zero on entry and on exit.
enum Word {
  kCursor = 0,
  kThreadCount,
  kWarpCount,
  kMergeCount,
  kBlockCount,
  kRuns,
  kMostPasses,
  kNext,
  kDone,
  kWords
};

template <class T>
struct Sum {
  T* out;             // [n] base, then the sums
  const T* base;      // [n]
  int n;
  int vec;            // values a thread copies from base to out
  const int* index;   // [k]
  const T* values;    // [k]
  int k;
  int* words;         // [kWords]
  int* seg_count;     // [n] updates an index gets; zero on entry and exit
  int2* span;         // [n] (start, length) of an index's segment
  int* place;         // [k] place in the segment; -1 when there is no record
  Record<T>* rec;     // [k] the segments' records
  Record<T>* rec2;    // [k] the merge tier's second buffer
  int* thread_segs;   // [k / 2 + 1] indices whose segment has 2..8 updates
  int* warp_segs;     // [k / 9 + 1] 9..kWarpSort
  int* long_segs;     // [long_cap] more: past kBlockSort from the front,
                      // the others from the back
  int long_cap;
  // the merge tier's queue (below): a merge segment's first run, the
  // segment of each run, a segment's items done (zero on entry and exit)
  int* run_base;      // [long_cap]
  int* run_owner;     // [k / 1024 + 64]
  int* progress;      // [long_cap], after seg_count
};

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// The merge tier's passes for a segment of len: log2 of its runs, rounded up.
__device__ __forceinline__ int merge_passes(int len) {
  int passes = 0;
  for (long long w = kBlockSort; w < len; w *= 2) ++passes;
  return passes;
}

// ------------------------------------------------------------- 1. count
template <class T>
__global__ void __launch_bounds__(kThreads) count_pass(Sum<T> s) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i < static_cast<unsigned>(s.k)) {
    const int key = s.index[i];
    s.place[i] =
        key >= 0 && key < s.n ? atomicAdd(s.seg_count + key, 1) : -1;
  }
  // out = base: 16 bytes a thread where base is aligned to 16, else one
  // value a thread
  const unsigned vecs = static_cast<unsigned>(s.n) / s.vec;
  if (i < vecs) {
    if (s.vec > 1) {
      reinterpret_cast<int4*>(s.out)[i] =
          reinterpret_cast<const int4*>(s.base)[i];
    } else {
      s.out[i] = s.base[i];
    }
  } else if (i < vecs + static_cast<unsigned>(s.n) % s.vec) {
    const unsigned j = (i - vecs) + vecs * s.vec;
    s.out[j] = s.base[j];
  }
}

// ----------------------------------------------------------- 2. reserve
// A segment of one update is added here at once: no record, no list.
template <class T>
__global__ void __launch_bounds__(kThreads) reserve_pass(Sum<T> s) {
  __shared__ int warp_sums[kThreads / 32];
  __shared__ int bases[5];
  const unsigned first =
      blockIdx.x * kReserveTile + threadIdx.x * kReservePer;
  int key[kReservePer];
  int len[kReservePer];
#pragma unroll
  for (int j = 0; j < kReservePer; ++j) {
    const unsigned u = first + j;
    key[j] = u < static_cast<unsigned>(s.k) && s.place[u] == 0 ? s.index[u]
                                                                 : -1;
  }
  int need = 0;
  int small = 0;  // (by thread << 16) | by warp, each at most kReserveTile
  int large = 0;  // (merge << 16) | block
#pragma unroll
  for (int j = 0; j < kReservePer; ++j) {
    len[j] = key[j] >= 0 ? s.seg_count[key[j]] : 0;
    if (len[j] > 1) need += len[j];
    small += len[j] > kWarpSort     ? 0
             : len[j] > kThreadSort ? 1
             : len[j] > 1           ? 1 << 16
                                    : 0;
    large += len[j] > kBlockSort  ? 1 << 16
             : len[j] > kWarpSort ? 1
                                  : 0;
  }
  int total;
  int at = block_exclusive_scan<kThreads>(need, warp_sums, total);
  int smalls;
  const int on_small = block_exclusive_scan<kThreads>(small, warp_sums,
                                                      smalls);
  int larges;
  const int on_large = block_exclusive_scan<kThreads>(large, warp_sums,
                                                      larges);
  if (threadIdx.x == 0) {
    bases[0] = atomicAdd(s.words + kCursor, total);
    bases[1] = atomicAdd(s.words + kThreadCount, smalls >> 16);
    bases[2] = atomicAdd(s.words + kWarpCount, smalls & 0xffff);
    bases[3] = atomicAdd(s.words + kMergeCount, larges >> 16);
    bases[4] = atomicAdd(s.words + kBlockCount, larges & 0xffff);
  }
  __syncthreads();
  at += bases[0];
  int on_thread = bases[1] + (on_small >> 16);
  int on_warp = bases[2] + (on_small & 0xffff);
  int on_merge = bases[3] + (on_large >> 16);
  int on_block = bases[4] + (on_large & 0xffff);
#pragma unroll
  for (int j = 0; j < kReservePer; ++j) {
    const int t = key[j];
    if (t < 0) continue;
    if (len[j] == 1) {
      const unsigned u = first + j;
      s.out[t] = add_rn(s.out[t], s.values[u]);
      s.seg_count[t] = 0;
      s.place[u] = -1;
      continue;
    }
    s.span[t] = make_int2(at, len[j]);
    at += len[j];
    if (len[j] > kBlockSort) {
      const int runs = (len[j] + kBlockSort - 1) / kBlockSort;
      const int run0 = atomicAdd(s.words + kRuns, runs);
      atomicMax(s.words + kMostPasses, merge_passes(len[j]));
      for (int r = run0; r < run0 + runs; ++r) s.run_owner[r] = on_merge;
      s.run_base[on_merge] = run0;
      s.long_segs[on_merge++] = t;
    } else if (len[j] > kWarpSort) {
      s.long_segs[s.long_cap - 1 - on_block++] = t;
    } else if (len[j] > kThreadSort) {
      s.warp_segs[on_warp++] = t;
    } else {
      s.thread_segs[on_thread++] = t;
    }
  }
}

// ------------------------------------------------------------- 3. place
template <class T>
__global__ void __launch_bounds__(kThreads) place_pass(Sum<T> s) {
  const unsigned u = blockIdx.x * kThreads + threadIdx.x;
  if (u == 0) s.words[kCursor] = 0;  // the reservations are done
  if (u >= static_cast<unsigned>(s.k)) return;
  const int p = s.place[u];
  if (p < 0) return;
  store_record(s.rec + s.span[s.index[u]].x + p, static_cast<int>(u),
               s.values[u]);
}

// --------------------------------------------------------------- 4. sum
// Each tier sorts a segment by update id, adds it onto out[t] and sets its
// count back to 0.

template <class T>
__device__ __forceinline__ void close_segment(const Sum<T>& s, int t,
                                              T acc) {
  s.out[t] = acc;
  s.seg_count[t] = 0;
}

// acc + buf[0] + buf[1] + ... + buf[len - 1], left to right, from shared
// memory: the loads of the next eight values are issued before the adds of
// these eight, so the chain of adds does not wait on them.
template <class T>
__device__ __forceinline__ T add_in_order(T acc, const T* buf, int len) {
  constexpr int kBatch = 8;
  int i = 0;
  if (len >= kBatch) {
    T v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) v[j] = buf[j];
    for (i = kBatch; i + kBatch <= len; i += kBatch) {
      T next[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) next[j] = buf[i + j];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) acc = add_rn(acc, v[j]);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) v[j] = next[j];
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) acc = add_rn(acc, v[j]);
  }
  for (; i < len; ++i) acc = add_rn(acc, buf[i]);
  return acc;
}

// 1 < len <= kThreadSort, by one thread: an odd-even transposition sort in
// registers.
template <class T>
__device__ __forceinline__ void sum_by_thread(const Sum<T>& s, int t,
                                              int start, int len) {
  int id[kThreadSort];
  T v[kThreadSort];
#pragma unroll
  for (int j = 0; j < kThreadSort; ++j) {
    id[j] = INT_MAX;
    v[j] = T(0);
    if (j < len) {
      const Record<T> r = load_record(s.rec + start + j);
      id[j] = r.id;
      v[j] = r.v;
    }
  }
#pragma unroll
  for (int r = 0; r < kThreadSort; ++r) {
#pragma unroll
    for (int j = r & 1; j + 1 < kThreadSort; j += 2) {
      const bool swap = id[j] > id[j + 1];
      const int lo = swap ? id[j + 1] : id[j];
      const int hi = swap ? id[j] : id[j + 1];
      const T vlo = swap ? v[j + 1] : v[j];
      const T vhi = swap ? v[j] : v[j + 1];
      id[j] = lo;
      id[j + 1] = hi;
      v[j] = vlo;
      v[j + 1] = vhi;
    }
  }
  T acc = s.out[t];
#pragma unroll
  for (int j = 0; j < kThreadSort; ++j) {
    if (j < len) acc = add_rn(acc, v[j]);
  }
  close_segment(s, t, acc);
}

// kThreadSort < len <= kWarpRank, by one warp (every lane calls it with the
// same segment): each lane ranks two entries against all by shuffles, the
// values land at their ranks in `buf` and lane 0 adds them.
template <class T>
__device__ void sum_by_warp(const Sum<T>& s, int t, int start, int len,
                            T* buf) {
  const int lane = threadIdx.x & 31;
  Record<T> r0{INT_MAX};
  Record<T> r1{INT_MAX};
  if (lane < len) r0 = load_record(s.rec + start + lane);
  if (lane + 32 < len) r1 = load_record(s.rec + start + lane + 32);
  int k0 = 0;
  int k1 = 0;
  for (int j = 0; j < 32; ++j) {
    const int a = __shfl_sync(kFull, r0.id, j);
    const int b = __shfl_sync(kFull, r1.id, j);
    k0 += (a < r0.id) + (b < r0.id);
    k1 += (a < r1.id) + (b < r1.id);
  }
  if (lane < len) buf[k0] = r0.v;
  if (lane + 32 < len) buf[k1] = r1.v;
  __syncwarp();
  if (lane == 0) close_segment(s, t, add_in_order(s.out[t], buf, len));
  __syncwarp();
}

// sid[i], sval[i] = the id and value of rec[i] for i < len <= kBlockSort,
// by the whole block; each thread issues all its loads before its first
// store.
template <class T>
__device__ __forceinline__ void stage(const Record<T>* rec, int len,
                                      int* sid, T* sval) {
  constexpr int kEach = kBlockSort / kThreads;
  Record<T> r[kEach];
#pragma unroll
  for (int c = 0; c < kEach; ++c) {
    const int i = threadIdx.x + c * kThreads;
    if (i < len) r[c] = load_record(rec + i);
  }
#pragma unroll
  for (int c = 0; c < kEach; ++c) {
    const int i = threadIdx.x + c * kThreads;
    if (i < len) {
      sid[i] = r[c].id;
      sval[i] = r[c].v;
    }
  }
}

// Where the merge path of the sorted runs a[al] and b[bl] (ids distinct)
// crosses diagonal d: how many of the first d entries of their merge come
// from a.  `id(x, i)` reads the id of run x's entry i.
template <class Id>
__device__ __forceinline__ int merge_split(Id id, int al, int bl, int d) {
  int lo = max(0, d - bl);
  int hi = min(d, al);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (id(0, mid) < id(1, d - 1 - mid)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Sorts the kWarpSort (id, value) pairs a warp holds, 8 a lane (lane l
// holds entries 8l .. 8l + 7), by id, in place: a bitonic network whose
// steps within a lane are register swaps and whose steps across lanes are
// shuffles.  Ids are distinct (pads INT_MAX).
template <class T>
__device__ __forceinline__ void warp_sort(int (&id)[8], T (&v)[8]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= kWarpSort; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int e = lane * 8 + r;
        const bool up = (e & k) == 0;  // this pair sorts ascending
        if (j >= 8) {
          const int other = __shfl_xor_sync(kFull, id[r], j >> 3);
          const T other_v = __shfl_xor_sync(kFull, v[r], j >> 3);
          // the lower entry of an ascending pair keeps the smaller id
          const bool lower = (e & j) == 0;
          if ((lower == up) ? other < id[r] : other > id[r]) {
            id[r] = other;
            v[r] = other_v;
          }
        } else if ((r & j) == 0 &&
                   (up ? id[r] > id[r | j] : id[r] < id[r | j])) {
          const int i = id[r];
          id[r] = id[r | j];
          id[r | j] = i;
          const T x = v[r];
          v[r] = v[r | j];
          v[r | j] = x;
        }
      }
    }
  }
}

// A warp's entries 8 a lane from records rec[0 .. len) (INT_MAX pads past
// len), each lane's eight loads issued together.
template <class T>
__device__ __forceinline__ void warp_load(const Record<T>* rec, int len,
                                          int (&id)[8], T (&v)[8]) {
  const int lane = threadIdx.x & 31;
  Record<T> r[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int i = lane * 8 + c;
    r[c] = i < len ? load_record(rec + i) : Record<T>{INT_MAX};
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    id[c] = r[c].id;
    v[c] = r[c].v;
  }
}

// kWarpRank < len <= kWarpSort, by one warp: the warp sort, the values in
// order into `buf` (kWarpSort of this warp), lane 0 adds them.
template <class T>
__device__ void sum_by_warp_sort(const Sum<T>& s, int t, int start, int len,
                                 T* buf) {
  const int lane = threadIdx.x & 31;
  int id[8];
  T v[8];
  warp_load(s.rec + start, len, id, v);
  warp_sort(id, v);
#pragma unroll
  for (int c = 0; c < 8; ++c) buf[lane * 8 + c] = v[c];
  __syncwarp();
  if (lane == 0) close_segment(s, t, add_in_order(s.out[t], buf, len));
  __syncwarp();
}

// Loads len <= kBlockSort records into sid / sval and sorts them by id: the
// warps sort chunks of kWarpSort (warp_sort; INT_MAX pads up to a power of
// two), then rounds of merges in shared memory double the sorted runs, each
// thread merging kBlockSort / kThreads outputs (a merge-path search, then
// in order) into registers and writing them back after a barrier.  The
// whole block calls it.
template <class T>
__device__ void block_sort(const Record<T>* rec, int len, int* sid,
                           T* sval) {
  constexpr int kPer = kBlockSort / kThreads;
  int size = kWarpSort;
  while (size < len) size <<= 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp * kWarpSort < size) {
    int id[8];
    T v[8];
    warp_load(rec + warp * kWarpSort, len - warp * kWarpSort, id, v);
    warp_sort(id, v);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      sid[warp * kWarpSort + lane * 8 + c] = id[c];
      sval[warp * kWarpSort + lane * 8 + c] = v[c];
    }
  }
  __syncthreads();
  for (int w = kWarpSort; w < size; w *= 2) {
    const int d0 = threadIdx.x * kPer;
    int id[kPer];
    T v[kPer];
    if (d0 < size) {
      const int base = d0 / (2 * w) * (2 * w);
      const int* a = sid + base;
      const int* b = a + w;
      int i = merge_split([&](int x, int at) { return a[x * w + at]; }, w, w,
                          d0 - base);
      int j = d0 - base - i;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const bool take_a = j >= w || (i < w && a[i] < b[j]);
        const int at = take_a ? base + i++ : base + w + j++;
        id[c] = sid[at];
        v[c] = sval[at];
      }
    }
    __syncthreads();
    if (d0 < size) {
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        sid[d0 + c] = id[c];
        sval[d0 + c] = v[c];
      }
    }
    __syncthreads();
  }
}

// The merge tier.  A segment of len > kBlockSort is work items on the sum
// launch's queue, each done by one block: its R = ceil(len / kBlockSort)
// runs sorted in shared memory (R items), then P = ceil(log2 R) passes that
// merge pairs of runs, R output tiles of kBlockSort each (R items a pass),
// then its add (one item).  The queue holds stage by stage the items of
// every merge segment: all runs, then every segment's first pass, and so
// on, then the adds.  An item waits until every item of the stage before
// it, in its own segment, is done: those stand earlier in the queue, so
// blocks that run took them, and none of them waits on a later item: every
// wait ends.

// Run r of a segment's records, sorted in place.
template <class T>
__device__ void sort_run(Record<T>* rec, int len, int r, int* sid, T* sval) {
  const int lo = r * kBlockSort;
  const int rl = min(kBlockSort, len - lo);
  block_sort(rec + lo, rl, sid, sval);
  for (int i = threadIdx.x; i < rl; i += kThreads) {
    store_record(rec + lo + i, sid[i], sval[i]);
  }
}

// merge_split over two runs of records in global memory, by one warp: each
// round the 32 lanes test 32 points of the range at once, and the test's
// answers (true up to the split) narrow it 32-fold, so a round costs one
// load's latency where a binary search pays five.
template <class T>
__device__ int warp_merge_split(const Record<T>* a, int al, int bl, int d) {
  const int lane = threadIdx.x & 31;
  const Record<T>* b = a + al;
  int lo = max(0, d - bl);
  int hi = min(d, al);
  while (hi > lo) {
    const int step = (hi - lo + 31) / 32;
    const int at = lo + lane * step;
    const bool before = at < hi && __ldcg(&a[at].id) < __ldcg(&b[d - 1 - at].id);
    const int c = __popc(__ballot_sync(kFull, before));
    if (step == 1) return lo + c;
    if (c == 0) return lo;
    hi = min(lo + c * step, hi);
    lo = lo + (c - 1) * step + 1;
  }
  return lo;
}

// Output tile q (kBlockSort entries) of the merge pass that turns src's
// sorted runs of w entries into dst's runs of 2w: thread 0 and thread 1
// find where the tile starts and ends in its pair's first run (merge-path
// searches), the tile's share of both runs is staged side by side in
// shared memory, and each thread merges kBlockSort / kThreads outputs.
template <class T>
__device__ void merge_tile(const Record<T>* src, Record<T>* dst, int len,
                           long long w, int q, int* sid, T* sval,
                           int* cut) {
  const long long d0 = static_cast<long long>(q) * kBlockSort;
  const long long lo = d0 / (2 * w) * (2 * w);
  const long long whole = len;
  const int al = static_cast<int>(min(lo + w, whole) - lo);
  const int bl = static_cast<int>(min(lo + 2 * w, whole) - lo) - al;
  const int d_start = static_cast<int>(d0 - lo);
  const int d_end = min(d_start + kBlockSort, al + bl);
  const Record<T>* a = src + lo;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int d = warp == 0 ? d_start : d_end;
    const int at = d == al + bl ? al : warp_merge_split(a, al, bl, d);
    if ((threadIdx.x & 31) == 0) cut[warp] = at;
  }
  __syncthreads();
  const int a0 = cut[0];
  const int a1 = cut[1];
  const int b0 = d_start - a0;
  const int na = a1 - a0;
  const int nb = d_end - a1 - b0;
  stage(a + a0, na, sid, sval);
  stage(a + al + b0, nb, sid + na, sval + na);
  __syncthreads();
  constexpr int kPer = kBlockSort / kThreads;
  int d = threadIdx.x * kPer;
  const int stop = min(d + kPer, na + nb);
  if (d < stop) {
    int i = merge_split([&](int x, int at) { return sid[x * na + at]; }, na,
                        nb, d);
    int j = d - i;
    Record<T>* out = dst + lo + d_start;
    for (; d < stop; ++d) {
      const int at =
          j >= nb || (i < na && sid[i] < sid[na + j]) ? i++ : na + j++;
      store_record(out + d, sid[at], sval[at]);
    }
  }
}

// The segment's sorted records added in order onto out[t], through the two
// halves of sval: chunk c of kHalf values lands in half c & 1 while thread
// 0 adds chunk c - 1.
template <class T>
__device__ void add_merged(const Sum<T>& s, int t, const Record<T>* rec,
                           int len, T* sval) {
  constexpr int kEach = kHalf / kThreads;
  T acc = threadIdx.x == 0 ? s.out[t] : T(0);
  const int chunks = (len + kHalf - 1) / kHalf;
  for (int c = 0; c <= chunks; ++c) {
    if (c < chunks) {
      T* half = sval + (c & 1) * kHalf;
      const int lo = c * kHalf;
      const int cn = min(kHalf, len - lo);
      T v[kEach];
#pragma unroll
      for (int e = 0; e < kEach; ++e) {
        const int i = threadIdx.x + e * kThreads;
        v[e] = i < cn ? load_record(rec + lo + i).v : T(0);
      }
#pragma unroll
      for (int e = 0; e < kEach; ++e) half[threadIdx.x + e * kThreads] = v[e];
    }
    if (c > 0 && threadIdx.x == 0) {
      acc = add_in_order(acc, sval + ((c - 1) & 1) * kHalf,
                         min(kHalf, len - (c - 1) * kHalf));
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) close_segment(s, t, acc);
}

// Queue item `item` of the merge tier, by the whole block: of stage item /
// runs (runs = every merge segment's runs together; the stages past the
// most passes of any segment are the adds).
template <class T>
__device__ void merge_item(const Sum<T>& s, int item, int runs_all,
                           int stages, int* sid, T* sval, int* cut) {
  int stage = item / runs_all;
  int m = item - stages * runs_all;  // an add: the segment
  int q = 0;
  if (stage < stages) {
    const int r = item % runs_all;
    m = s.run_owner[r];
    q = r - s.run_base[m];
  }
  const int t = s.long_segs[m];
  const int2 sp = s.span[t];
  const int len = sp.y;
  const int runs = (len + kBlockSort - 1) / kBlockSort;
  const int passes = merge_passes(len);
  if (stage >= stages) {
    stage = passes + 1;
  } else if (stage > passes) {
    return;  // this segment has no such pass
  }
  if (threadIdx.x == 0 && stage > 0) {
    const volatile int* done = s.progress + m;
    unsigned spins = 0;
    while (*done < stage * runs) {
      __nanosleep(64);
      if (++spins > drain::kSpinLimit) __trap();
    }
    __threadfence();
  }
  __syncthreads();
  Record<T>* rec = s.rec + sp.x;
  Record<T>* rec2 = s.rec2 + sp.x;
  if (stage == 0) {
    sort_run(rec, len, q, sid, sval);
  } else if (stage <= passes) {
    // pass 1 reads the sorted runs in rec and writes rec2, pass 2 back
    const bool odd = stage & 1;
    merge_tile(odd ? rec : rec2, odd ? rec2 : rec, len,
               static_cast<long long>(kBlockSort) << (stage - 1), q, sid,
               sval, cut);
  } else {
    add_merged(s, t, passes & 1 ? rec2 : rec, len, sval);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (stage > passes) {
      s.progress[m] = 0;  // the segment is done: zero for the next call
    } else {
      __threadfence();
      atomicAdd(s.progress + m, 1);
    }
  }
}

// acc + vals[0] + ... + vals[len - 1], left to right, from global memory:
// the next 64 bytes of values are loaded before these are added.
template <class T>
__device__ T add_from_global(T acc, const T* vals, int len) {
  constexpr int kBatch = 64 / sizeof(T);
  int i = 0;
  if (len >= kBatch) {
    T v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) v[j] = __ldcg(vals + j);
    for (i = kBatch; i + kBatch <= len; i += kBatch) {
      T next[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) next[j] = __ldcg(vals + i + j);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) acc = add_rn(acc, v[j]);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) v[j] = next[j];
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) acc = add_rn(acc, v[j]);
  }
  for (; i < len; ++i) acc = add_rn(acc, __ldcg(vals + i));
  return acc;
}

// The next item of the sum launch's queue, for the whole block.
__device__ __forceinline__ int take(int* words, int* taken) {
  if (threadIdx.x == 0) *taken = atomicAdd(words + kNext, 1);
  __syncthreads();
  const int i = *taken;
  __syncthreads();  // taken is the next turn's
  return i;
}

// The adds a block put off: thread i adds the i-th segment it sorted, from
// the sorted values written over the segment's records.
template <class T>
__device__ void deferred_adds(const Sum<T>& s, const int* deferred,
                              int n_deferred) {
  if (static_cast<int>(threadIdx.x) < n_deferred) {
    const int t = deferred[threadIdx.x];
    const int2 sp = s.span[t];
    close_segment(s, t, add_from_global(
        s.out[t], reinterpret_cast<const T*>(s.rec + sp.x), sp.y));
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads, 3) sum_pass(Sum<T> s) {
  __shared__ int sid[kBlockSort];
  __shared__ T sval[kBlockSort];
  __shared__ int cut[2];
  __shared__ int taken;
  __shared__ int deferred[kThreads];
  const int tid = threadIdx.x;
  // the merge tier's items first, from a queue, then the segments of the
  // block tier.  A block-tier segment's sort takes the whole block and its
  // add one thread, so while the queue has more, a block writes the sorted
  // values back and puts the add off; its threads do the adds put off
  // together, a segment each, when it has kThreads of them or the queue is
  // empty.
  const int runs_all = s.words[kRuns];
  const int stages = s.words[kMostPasses] + 1;
  const int n_items = stages * runs_all + s.words[kMergeCount];
  const int n_queue = n_items + s.words[kBlockCount];
  int n_deferred = 0;
  int i = take(s.words, &taken);
  while (i < n_queue) {
    if (i < n_items) {
      merge_item(s, i, runs_all, stages, sid, sval, cut);
      i = take(s.words, &taken);
      continue;
    }
    const int t = s.long_segs[s.long_cap - 1 - (i - n_items)];
    const int2 sp = s.span[t];
    block_sort(s.rec + sp.x, sp.y, sid, sval);
    i = take(s.words, &taken);
    if (i < n_queue) {
      T* vals = reinterpret_cast<T*>(s.rec + sp.x);
      for (int c = tid; c < sp.y; c += kThreads) vals[c] = sval[c];
      if (tid == 0) deferred[n_deferred] = t;
      if (++n_deferred == kThreads) {
        __syncthreads();
        deferred_adds(s, deferred, n_deferred);
        n_deferred = 0;
      }
    } else if (tid == 0) {
      close_segment(s, t, add_in_order(s.out[t], sval, sp.y));
    }
    __syncthreads();
  }
  deferred_adds(s, deferred, n_deferred);
  // a segment a warp, then a segment a thread
  const int warps = gridDim.x * (kThreads / 32);
  const int n_warp = s.words[kWarpCount];
  for (int i = blockIdx.x * (kThreads / 32) + (tid >> 5); i < n_warp;
       i += warps) {
    const int t = s.warp_segs[i];
    const int2 sp = s.span[t];
    T* buf = sval + (tid >> 5) * kWarpSort;
    if (sp.y <= kWarpRank) {
      sum_by_warp(s, t, sp.x, sp.y, buf);
    } else {
      sum_by_warp_sort(s, t, sp.x, sp.y, buf);
    }
  }
  const int n_thread = s.words[kThreadCount];
  for (int i = blockIdx.x * kThreads + tid; i < n_thread;
       i += gridDim.x * kThreads) {
    const int t = s.thread_segs[i];
    const int2 sp = s.span[t];
    sum_by_thread(s, t, sp.x, sp.y);
  }
  // the last block to finish clears the lists for the next call
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(s.words + kDone, 1) == static_cast<int>(gridDim.x) - 1) {
      for (int w = kThreadCount; w < kWords; ++w) s.words[w] = 0;
    }
  }
}

inline unsigned blocks_for(unsigned items, unsigned per_block) {
  return (items + per_block - 1) / per_block;
}

// The work buffer's regions, each aligned to 256 bytes.
struct Layout {
  size_t rec, rec2, span, place, thread_segs, warp_segs, long_segs, long_cap,
      run_base, run_owner, bytes;
};

inline Layout layout(int n, int k, int record) {
  auto up = [](size_t x) { return (x + 255) & ~static_cast<size_t>(255); };
  const size_t kk = static_cast<size_t>(k);
  Layout l;
  l.long_cap = kk / (kWarpSort + 1) + 1;
  l.rec = 0;
  l.rec2 = l.rec + up(kk * record);
  l.span = l.rec2 + up(kk * record);
  l.place = l.span + up(static_cast<size_t>(n) * sizeof(int2));
  l.thread_segs = l.place + up(kk * sizeof(int));
  l.warp_segs = l.thread_segs + up((kk / 2 + 1) * sizeof(int));
  l.long_segs = l.warp_segs + up((kk / (kThreadSort + 1) + 1) * sizeof(int));
  l.run_base = l.long_segs + up(l.long_cap * sizeof(int));
  l.run_owner = l.run_base + up(l.long_cap * sizeof(int));
  l.bytes = l.run_owner + up((kk / 1024 + 64) * sizeof(int));
  return l;
}

template <class T>
cudaError_t launch(T* out, const T* base, int n, const int* index,
                   const T* values, int k, int* counts, void* work,
                   cudaStream_t stream) {
  if (k <= 0 || n <= 0) return cudaSuccess;
  drain::DeviceInfo info;
  cudaError_t err = drain::device_info(&info);
  if (err != cudaSuccess) return err;
  const Layout l = layout(n, k, sizeof(Record<T>));
  char* w = static_cast<char*>(work);
  // out is a fresh allocation; base may be a view off the 16-byte grid
  const bool aligned = reinterpret_cast<uintptr_t>(base) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const Sum<T> s{out,
                 base,
                 n,
                 aligned ? static_cast<int>(16 / sizeof(T)) : 1,
                 index,
                 values,
                 k,
                 counts,
                 counts + kWords,
                 reinterpret_cast<int2*>(w + l.span),
                 reinterpret_cast<int*>(w + l.place),
                 reinterpret_cast<Record<T>*>(w + l.rec),
                 reinterpret_cast<Record<T>*>(w + l.rec2),
                 reinterpret_cast<int*>(w + l.thread_segs),
                 reinterpret_cast<int*>(w + l.warp_segs),
                 reinterpret_cast<int*>(w + l.long_segs),
                 static_cast<int>(l.long_cap),
                 reinterpret_cast<int*>(w + l.run_base),
                 reinterpret_cast<int*>(w + l.run_owner),
                 counts + kWords + n};
  const unsigned copies =
      static_cast<unsigned>(n) / s.vec + static_cast<unsigned>(n) % s.vec;
  const unsigned top = copies > static_cast<unsigned>(k) ? copies : k;
  count_pass<T><<<blocks_for(top, kThreads), kThreads, 0, stream>>>(s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reserve_pass<T><<<blocks_for(k, kReserveTile), kThreads, 0, stream>>>(s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  place_pass<T><<<blocks_for(k, kThreads), kThreads, 0, stream>>>(s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the lists' lengths are on the card: as many blocks as are resident at
  // once walk them
  static int resident[2] = {0, 0};
  int& per_sm = resident[sizeof(T) == 8];
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sum_pass<T>,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
  }
  sum_pass<T><<<info.sms * per_sm, kThreads, 0, stream>>>(s);
  return cudaGetLastError();
}

}  // namespace

// out[n] gets base[n] with values[k] added at index[k] in update order.
// `counts` holds ordered_scatter_add_counts(n, k) ints, zero on entry and
// left so; `work`
// ordered_scatter_add_work_bytes(n, k, 4) bytes of scratch, 256-byte
// aligned.  Launches on `stream`; returns the cudaError_t of the launches.
extern "C" int ordered_scatter_add_launch(float* out, const float* base,
                                          int n, const int* index,
                                          const float* values, int k,
                                          int* counts, void* work,
                                          cudaStream_t stream) {
  return launch(out, base, n, index, values, k, counts, work, stream);
}

// The same in float64 (`work` sized with elem 8).
extern "C" int ordered_scatter_add_f64_launch(double* out, const double* base,
                                              int n, const int* index,
                                              const double* values, int k,
                                              int* counts, void* work,
                                              cudaStream_t stream) {
  return launch(out, base, n, index, values, k, counts, work, stream);
}

// The ints `counts` holds for n slots and k updates: the words, a count
// per slot, a count per merge-tier segment.
extern "C" long long ordered_scatter_add_counts(int n, int k) {
  return kWords + static_cast<long long>(n) +
         static_cast<long long>(k) / (kWarpSort + 1) + 1;
}

// Bytes of `work` for n slots, k updates and values of `elem` bytes.
extern "C" long long ordered_scatter_add_work_bytes(int n, int k, int elem) {
  const int record = elem == 4 ? sizeof(Record<float>) : sizeof(Record<double>);
  return static_cast<long long>(layout(n, k, record).bytes);
}
