// Speculative BFS's whole drain in one cooperative launch, kernel B3.
//
// Replaces the TPU kernel `make_fused_drain` / `fused_drain_pallas`
// (pallas_call at src/repro/kernels/drain_loop/kernel.py:121) for the BFS
// program at every granularity 1 <= G <= 64, with merge-path or per_item
// expansion.  The Pallas kernel traced the persistent drain's
// `while cond: step` loop to a jaxpr and evaluated it inside the kernel body
// with `jax.core.eval_jaxpr`, so one kernel served any program.  Nothing on
// the GPU evaluates a jaxpr; this is the BFS program written out by hand,
// one launch per drain.  It computes exactly what the port's plain fused
// drain (`fused_drain_ref` over `wavefront_step` with the BFS body)
// computes, while
//
//   rounds < min(max_rounds, limit) and tail - head > 0:
//
//   1. pop      items[l] = buf[(head + l) % cap] for l < k = min(size, W),
//               each a chunk (head, width) (drain_common.cuh's codec);
//   2. scan     the inclusive int32 scan of the chunks' degrees; total;
//   3. truncate truncated[l] = scan[l] > budget (merge path: the chunk is
//               re-queued whole; per_item never truncates);
//   4. expand   every unit u < L = min(total, budget): owner by an
//               upper-bound search of the scan (kernel B1's search), rank,
//               src the member row of the rank (chunk_row_of), and nbr the
//               word of the chunk's row slice at the rank (kernel B4's
//               stream: a chunk's rows are contiguous in CSR);
//   5. relax    cand = dist[src] + 1 and before = dist[nbr], both read from
//               the round-start dist; improved = live & cand < before;
//   6. dedup    of the improved units with one nbr only the lowest stays:
//               atomicMin of ((max_rounds - round) << 32 | unit) on a 64-bit
//               word per vertex; and the new dist[nbr], the least cand, by
//               atomicMin of ((max_rounds - round) << 32 | cand ^ 2^31) on
//               a second word (the flipped sign bit orders int32 as
//               unsigned).  Keys fall from round to round, so neither array
//               needs a reset, and dist itself is not written until every
//               read of step 5 is done: the unit that stays writes it;
//   7. coalesce the kept neighbors into chunks over G-aligned windows
//               (drain_common.cuh's window_add / window_emit; G > 1);
//   8. push     [chunks of the kept units, unit order] ++ [truncated items,
//               wavefront order] into the ring at tail + rank, ranks from
//               prefix sums (never an atomic ticket), so the ring is
//               bit-identical to TaskQueue.push; what exceeds cap - size is
//               dropped and counted;
//   9. counters work += the widths of the chunks not truncated, splits +=
//               the windows split, processed += k, rounds and the
//               WorkCounter's rounds += 1.
//
// per_item is merge path with no budget.  The plain per_item body expands
// each chunk's member rows into a [k G, max_degree] padded lane grid; its
// lane order is chunk, member row, edge, which is the order of the units
// (chunk, rank) here, so the lowest unit of a neighbor is the reference's
// lowest lane.  A task's head is a vertex in [0, n), as every push makes it.
//
// Structure.  The grid is as many blocks as fit on the card at once (one an
// SM) and is launched with cudaLaunchCooperativeKernel, which refuses a grid
// that could not be co-resident instead of hanging.  Every block keeps the
// cursors in registers and updates them identically, so the loop condition
// is the same in every block.  A round:
//
//   * pop: every block reads the whole wavefront into shared memory, the
//     ring word, degree, first edge offset and (G = 1) dist[item] + 1 of
//     each lane, neighbouring threads on neighbouring lanes, kBatch lanes a
//     thread in flight (the first batch issued at the end of the round
//     before, beside the read of its push count); it scans the degrees by
//     warps over contiguous words.  No lane reads row_ptr or dist here: a
//     lane's data were written once in the grid during the round before,
//     for the tasks already waiting in the ring by the grid after its first
//     barrier, for each pushed task by the thread that pushes it, and for
//     the launch's first wavefront before its first barrier.  A lane's
//     dist[item] + 1 is the round-start value the units read: the least
//     cand of an item the round before improved (its dedup word carries
//     that round's stamp), else dist[item], which that round did not
//     write;
//   * the round's push positions (the units up to L, then the wavefront's
//     items) are cut into tiles of T = min(ceil(P / grid), kPass)
//     positions, tile t taken by block t % grid: one tile a block while
//     the round fits, as at rmat(21) under the default budget; a thread
//     holds the positions t T + s kThreads + tid for s < kDepth, so one
//     pass keeps all its units' loads in flight together (the col_idx
//     words, then the dist words, then the atomics); at G = 1 a unit reads
//     no row_ptr and no dist[src];
//   * barrier; each kept unit (its dedup word holds it) writes dist[nbr];
//     at G > 1 it joins its window, and after one more barrier reads it;
//   * push, a tile at a time: the kept positions are ranked by ballots, and
//     the tile's place in the round by a decoupled look-back over the
//     tiles' status words in tile order (as kernel B2 does; no ticket, the
//     grid being co-resident), each word stamped with the round so that
//     none is reset; the thread that writes a ring word also writes the
//     next wavefront's lane data of it; barrier, then every block reads the
//     round's push count from the last tile's inclusive word.
//
// A thread's units of the first tile stay in registers from the expansion
// to the push; a block with more tiles (a budget past grid x kPass units,
// or per_item) keeps a unit's nbr in `unit_nbr` (merge path) or finds it
// again (per_item).  Two grid barriers a round at G = 1 (after the
// atomics, after the push), three at G > 1 (and after the window adds).
// Values that other blocks write inside the launch (the ring, the lane
// data, the dedup words, the windows, the status words) are read with
// ld.global.cg, past the SM's incoherent L1.
//
// Modes.  The fused mode (B3-fused) drains lane 0 of the fused topology's
// one-lane MultiQueue: a popped word is unpacked to its task and a pushed
// task packed with job 0 (drain_common.cuh's lane_load / lane_store), which
// is what runtime/api.fused_lane_ops does around the same body.  The traced
// mode (B3-traced) writes one trace row a round from block 0 after the
// round's last barrier (drain_common.cuh's Tracer).  The slotted mode
// (B3-slotted) drains a streaming graph's slotted view: col_idx is its slab
// array, and a unit's word is the slab or overlay word of its member row at
// its in-row offset (drain_common.cuh's Slotted).  Each mode is a template
// argument, so the single, untraced, canonical instances are unchanged.
//
// What bounds the drain on an H100: bytes, about 8 bytes per expanded edge
// (its col_idx word and dist[nbr]) plus the ring traffic, far below the
// time a round takes.  A round is bound by issue and latency: 16 warps an
// SM run one round's code (about 4,700 instructions), and its chain of
// dependent L2 round trips (the pop, col_idx, dist, the dedup words, the
// look-back) and its two grid barriers leave little to overlap.

#include <cuda_runtime.h>

#include "csr_stream.cuh"
#include "drain_common.cuh"

namespace {

using namespace drain;

// kDepth 8: a tile of 4,096 positions holds a block's whole share of every
// rmat(21) round at W = 4096 and the default budget (at most 3,786), at
// most 128 registers a thread and no spill; 4 measured slower on an H100.
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDepth = 8;                 // positions a thread holds a tile
constexpr int kPass = kDepth * kThreads;  // the most positions of a tile
constexpr int kBatch = 8;                 // lanes a thread pops at a time
constexpr int kWaveArrays = 4;            // items, scan, offsets, cands

static_assert(kDepth * kWarps % 32 == 0, "a lane ranks whole (step, warp)s");

typedef unsigned long long Word;

struct Drain {
  int* buf;  // [cap] the task ring, updated in place
  int cap;
  int* dist;  // [n] hop distances, updated in place
  int n;
  const int* row_ptr;  // [n + 1]
  const int* col_idx;  // [m]; the slab array in the slotted mode
  int m;
  Slotted slotted;     // the slotted mode's slab and overlay arrays
  int* cursors;  // [kCursors]
  int wavefront;
  int budget;  // INT_MAX for per_item: no truncation, L = total
  int stored;  // units whose nbr unit_nbr can keep: budget, or 0
  int max_rounds;
  Codec codec;
  Windows win;
  int* unit_nbr;  // [stored] a kept unit's nbr past a block's first tile,
                  // -1 for none
  unsigned long long* first_unit;  // [n] dedup words, all ones at launch
  unsigned long long* best;        // [n] least-cand words, all ones
  int* lane_deg;   // [W] the next wavefront's lanes: chunk degree,
  int* lane_off;   // [W] row_ptr at the chunk's head,
  int* lane_cand;  // [W] and at G = 1 dist[head] + 1 at that round's start
  Word* status;   // [tiles_cap] look-back words, zero at launch
  int tiles_cap;
  unsigned int* barrier;  // [1] the grid barrier's arrivals; zero at launch
  int* wave_global;  // [gridDim.x][kWaveArrays W] when the wavefront does
                     // not fit in shared memory, else null
  long long* units;  // out: work units expanded, summed over rounds
  TraceRing trace;   // the traced mode's ring
};

// A tile's status word: the round's stamp r in the high half, then the
// prefix flag (bit 31) and the count; a word of an earlier round, or zero,
// is not yet published.
constexpr Word kPrefix = 1ull << 31;

__device__ __forceinline__ Word load_word(const Word* p) {
  return *reinterpret_cast<const volatile Word*>(p);
}

__device__ __forceinline__ void store_word(Word* p, Word w) {
  *reinterpret_cast<volatile Word*>(p) = w;
}

// The cand held by a least-cand word.
__device__ __forceinline__ int best_value(unsigned long long word) {
  return static_cast<int>(static_cast<unsigned>(word & 0xffffffffull) ^
                          0x80000000u);
}

// dist[v] + 1 at the next round's start, from v's dedup word `fu`, its
// least-cand word `bw` and dist[v] read after the dedup barrier of a round
// whose words are stamped `stamp`: the least cand where that round
// improved v (its kept unit writes it), dist[v] where it did not (nothing
// writes it); dist[v] + 1 before the first round (`stamp` 0).
__device__ __forceinline__ int next_cand(unsigned long long fu,
                                         unsigned long long bw, int dv,
                                         unsigned long long stamp) {
  const bool now = stamp && (fu >> 32) == (stamp >> 32);
  return wrap_add(now ? best_value(bw) : dv, 1);
}

// By warp 0 of the block that has tile `tile` > 0 of round r: the kept
// positions of all tiles before it, from their status words, summed back
// to the nearest inclusive one (every lane gets it).  A lane loads its
// words of kLookWindows windows of 32 tiles at once, then the windows are
// read in order, each lane polling its word until the word is this
// round's.  Every earlier tile is taken by a block that is running, so a
// wait that outlasts about half a minute is a fault and traps.
constexpr int kLookWindows = 8;

__device__ int look_back(const Word* status, int tile, unsigned r) {
  const int lane = threadIdx.x & 31;
  const Word before_first = kPrefix | (static_cast<Word>(r) << 32);
  int exclusive = 0;
  for (int pos = tile - 1;; pos -= 32 * kLookWindows) {
    Word w[kLookWindows];
#pragma unroll
    for (int i = 0; i < kLookWindows; ++i) {
      const int at = pos - 32 * i - lane;
      // before tile 0: a prefix of 0
      w[i] = at >= 0 ? load_word(status + at) : before_first;
    }
#pragma unroll
    for (int i = 0; i < kLookWindows; ++i) {
      const int at = pos - 32 * i - lane;
      const long long start = clock64();
      while (static_cast<unsigned>(w[i] >> 32) != r) {
        if (clock64() - start > kSpinCycles) __trap();
        w[i] = load_word(status + at);
      }
      const unsigned prefixes = __ballot_sync(kFull, (w[i] & kPrefix) != 0);
      // the nearest prefix is the lowest lane holding one; lanes past it
      // are earlier tiles that the prefix already counts
      const int last = prefixes ? __ffs(prefixes) - 1 : 31;
      int sum = lane <= last ? static_cast<int>(w[i] & 0x7fffffffull) : 0;
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(kFull, sum, off);
      }
      exclusive += sum;
      if (prefixes) return exclusive;
    }
  }
}

// The first j in [0, n) with s[j] > q (n where none), s rising, by a
// 32-ary search of the calling warp: each lane probes the last word of
// one of 32 segments, and the segments wholly at or below q are counted.
// Every lane of the warp takes part and gets the result.
__device__ __forceinline__ int warp_upper_bound(const int* s, int n, int q) {
  const int lane = threadIdx.x & 31;
  int lo = 0;
  int len = n;
  while (len > 32) {
    const int stride = (len + 31) >> 5;
    const int last = min((lane + 1) * stride, len) - 1;
    const int whole = __popc(__ballot_sync(kFull, s[lo + last] <= q));
    if (whole == 32) return lo + len;
    lo += whole * stride;
    len = min(stride, len - whole * stride);
  }
  return lo + __popc(__ballot_sync(kFull, lane < len && s[lo + lane] <= q));
}

// kChunks = false is the G = 1 instance, whose codec is the compile-time
// identity: no multiplication or division by G, no window code.  kPacked is
// the fused mode, kTraced the traced mode, kSlotted the slotted mode.
template <bool kChunks, bool kPacked, bool kTraced, bool kSlotted>
__global__ void __launch_bounds__(kThreads, 1) bfs_drain(Drain d) {
  extern __shared__ int dyn[];
  __shared__ int warp_sums[kWarps];
  __shared__ int step_count[kDepth * kWarps];  // a tile's kept positions by
                                               // (step, warp), then offsets
  __shared__ int tile_base;
  const int W = d.wavefront;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = gridDim.x;
  const Codec cc = kChunks ? d.codec : Codec{1, 0};
  int* items =
      d.wave_global
          ? d.wave_global + static_cast<size_t>(blockIdx.x) * kWaveArrays * W
          : dyn;
  int* scan = items + W;
  int* offs = scan + W;   // row_ptr at each lane's head
  int* cands = offs + W;  // G = 1: dist[item] + 1 of each lane

  int head = d.cursors[kHead];
  int tail = d.cursors[kTail];
  int dropped = d.cursors[kDropped];
  int rounds = d.cursors[kRounds];
  int processed = d.cursors[kProcessed];
  int work = d.cursors[kWork];
  const int splits = d.cursors[kSplits];
  int counter_rounds = d.cursors[kCounterRounds];
  const int limit = d.cursors[kLimit];
  Tracer<kTraced> tracer;
  tracer.begin(d.trace);

  // The lane data of a task, as two loads issued at once: row_ptr at its
  // head (`off`) and past its last member row (`end`, so that its chunk
  // degree is end - off); used where their values are needed.
  auto lane_data = [&](int task, int& off, int& end) {
    const int lo = clamp_to(chunk_head(task, cc), 0, d.n);
    const int hi = clamp_to(wrap_add(lo, chunk_width(task, cc)), 0, d.n);
    off = __ldg(d.row_ptr + lo);
    end = __ldg(d.row_ptr + hi);
  };
  // The tasks of the ring from `from` as lanes [0, min(count, W)) of the
  // next wavefront, the grid reading each once, block b's first threads
  // lanes b, b + grid, ...: begin_waiting issues the ring word of this
  // thread's first lane, issue_lane its loads, end_waiting writes its lane
  // data and does the rest.  `stamp` is the ending round's, or 0 before
  // the first round.
  const int n_threads = G * kThreads;
  const int wait_lane = blockIdx.x + G * tid;
  auto begin_waiting = [&](int from, int count) {
    return wait_lane < min(count, W)
               ? __ldcg(d.buf + ring_slot(wrap_add(from, wait_lane), d.cap))
               : 0;
  };
  // A lane's loads, issued together: its lane data, and at G = 1 dist[v]
  // and (after a round) v's dedup and least-cand words, for next_cand.
  struct LaneLoads {
    int off, end, dv;
    unsigned long long fu, bw;
  };
  auto issue_lane = [&](int task, unsigned long long stamp) {
    LaneLoads x{0, 0, 0, 0ull, 0ull};
    lane_data(task, x.off, x.end);
    if constexpr (!kChunks) {
      const int v = clamp_to(task, 0, d.n - 1);
      x.dv = __ldcg(d.dist + v);
      if (stamp) {
        x.fu = __ldcg(d.first_unit + v);
        x.bw = __ldcg(d.best + v);
      }
    }
    return x;
  };
  auto write_lane = [&](int l, const LaneLoads& x, unsigned long long stamp) {
    d.lane_deg[l] = wrap_sub(x.end, x.off);
    d.lane_off[l] = x.off;
    if constexpr (!kChunks) d.lane_cand[l] = next_cand(x.fu, x.bw, x.dv, stamp);
  };
  auto put_lane = [&](int l, int task, unsigned long long stamp) {
    write_lane(l, issue_lane(task, stamp), stamp);
  };
  // the rest of the waiting lanes, after this thread's first (`first`, the
  // loads of its task, or none past the waiting tasks)
  auto end_waiting = [&](int from, int count, const LaneLoads& first,
                         unsigned long long stamp) {
    if (wait_lane < min(count, W)) write_lane(wait_lane, first, stamp);
    for (int l = wait_lane + n_threads; l < min(count, W); l += n_threads) {
      put_lane(l,
               lane_load<kPacked>(
                   __ldcg(d.buf + ring_slot(wrap_add(from, l), d.cap))),
               stamp);
    }
  };
  end_waiting(head, wrap_sub(tail, head),
              issue_lane(lane_load<kPacked>(
                             begin_waiting(head, wrap_sub(tail, head))),
                         0ull),
              0ull);
  // the lanes are written, and every block has read the cursors before
  // block 0 may write them back
  grid_barrier(d.barrier);

  // The first kBatch lanes a thread of the wavefront from `from`, their
  // ring words and lane data, loaded before the round's size is known:
  // the loads go out beside the read of the round's push count.
  int pre_word[kBatch], pre_deg[kBatch], pre_off[kBatch], pre_cand[kBatch];
  int cand0 = 0;  // dist[0]: a lane past k reads dist[0] + 1, as item 0 would
  auto preload = [&](int from) {
    if constexpr (!kChunks) cand0 = __ldcg(d.dist);
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int at = tid + i * kThreads;
      pre_word[i] = pre_deg[i] = pre_off[i] = pre_cand[i] = 0;
      if (at < W) {
        pre_word[i] = __ldcg(d.buf + ring_slot(wrap_add(from, at), d.cap));
        pre_deg[i] = __ldcg(d.lane_deg + at);
        pre_off[i] = __ldcg(d.lane_off + at);
        if constexpr (!kChunks) pre_cand[i] = __ldcg(d.lane_cand + at);
      }
    }
  };
  preload(head);

  long long units = 0;
  const int rp0 = __ldg(d.row_ptr);  // offset of a lane past k
  while (rounds < d.max_rounds && rounds < limit && wrap_sub(tail, head) > 0) {
    const int size = wrap_sub(tail, head);
    const int k = size < W ? size : W;

    // 1-2. pop: the ring words and the lane data of the wavefront; a lane
    // past k holds no item and degree 0, and reads as item 0 would
    for (int l = tid; l < W; l += kBatch * kThreads) {
      int word[kBatch], deg[kBatch], off[kBatch], cand[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int at = l + i * kThreads;
        if (l == tid) {
          word[i] = pre_word[i];
          deg[i] = pre_deg[i];
          off[i] = pre_off[i];
          cand[i] = pre_cand[i];
        } else {
          const bool in = at < k;
          word[i] = in ? __ldcg(d.buf + ring_slot(wrap_add(head, at), d.cap))
                       : 0;
          deg[i] = in ? __ldcg(d.lane_deg + at) : 0;
          off[i] = in ? __ldcg(d.lane_off + at) : 0;
          cand[i] = !kChunks && in ? __ldcg(d.lane_cand + at) : 0;
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int at = l + i * kThreads;
        if (at < W) {
          const bool in = at < k;
          items[at] = in ? lane_load<kPacked>(word[i]) : kEmpty;
          scan[at] = in ? deg[i] : 0;
          offs[at] = in ? off[i] : rp0;
          if constexpr (!kChunks) {
            cands[at] = in ? cand[i] : wrap_add(cand0, 1);
          }
        }
      }
    }
    __syncthreads();
    scan_lanes<kThreads>(scan, W, warp_sums);
    const int total = scan[W - 1];
    const int L = total < 0 ? 0 : (total < d.budget ? total : d.budget);
    units += L;

    // the round's push positions, units [0, L) then items, in tiles
    const int P = wrap_add(L, k);
    const long long per_block = (static_cast<long long>(P) + G - 1) / G;
    const int T = static_cast<int>(
        min(per_block, static_cast<long long>(kPass)));
    const int tiles =
        static_cast<int>((static_cast<long long>(P) + T - 1) / T);
    if (tiles > d.tiles_cap) __trap();
    const unsigned long long stamp =
        static_cast<unsigned long long>(
            static_cast<unsigned>(wrap_sub(d.max_rounds, rounds)))
        << 32;
    const unsigned r = static_cast<unsigned>(rounds) + 1u;

    // The owner lane, rank, member row and nbr of each unit of this thread
    // in the tile [t0, u1): the owners lie in [o_lo, o_hi), found by each
    // warp, and each unit's is searched there, in shared memory, by the
    // threads and steps that hold a unit; the col_idx words are loaded
    // together.  Every thread of the block calls it.
    auto gather = [&](int t0, int u1, int (&owner)[kDepth],
                      int (&src)[kDepth], int (&nbr)[kDepth]) {
      const int o_lo = warp_upper_bound(scan, W, t0);
      const int o_hi = warp_upper_bound(scan, W, u1 - 1) + 1;
      // the steps that hold a unit of the tile
      const int steps = (u1 - t0 + kThreads - 1) / kThreads;
      int rank[kDepth];
#pragma unroll
      for (int s = 0; s < kDepth; ++s) {
        const int u = t0 + s * kThreads + tid;
        owner[s] = -1;
        rank[s] = 0;
        if (s < steps && u < u1) {
          const int o = o_lo + upper_bound(scan + o_lo, o_hi - o_lo, u);
          owner[s] = o;
          rank[s] = u - (o > 0 ? scan[o - 1] : 0);
        }
      }
#pragma unroll
      for (int s = 0; s < kDepth; ++s) {
        nbr[s] = -1;
        src[s] = 0;
        const int o = owner[s];
        if (o < 0) continue;
        const int item = o < k ? items[o] : 0;
        if constexpr (kChunks) {
          src[s] = chunk_row_of(d.row_ptr, chunk_head(item, cc), rank[s],
                                chunk_width(item, cc), d.n);
        } else {
          src[s] = clamp_to(item, 0, d.n - 1);
        }
        if constexpr (kSlotted) {
          // the in-row offset: the rank itself at G = 1, where the member
          // row is the head
          const int in_row =
              kChunks ? wrap_sub(wrap_add(offs[o], rank[s]),
                                 __ldg(d.row_ptr + src[s]))
                      : rank[s];
          nbr[s] = slotted_word(d.slotted, d.col_idx, src[s], in_row);
        } else {
          const long long e = csr_stream::slice_start(offs[o], d.m) +
                              clamp_to(rank[s], 0, d.budget - 1);
          nbr[s] = e < d.m ? __ldg(d.col_idx + e) : 0;
        }
      }
    };
    // the first unit and the last position of tile t
    auto tile_of = [&](int t, int& t0, int& t1) {
      t0 = t * T;
      t1 = t0 + min(T, P - t0);
    };

    // 4-6. expand; read, do not write, dist; claim the dedup and least-cand
    // words.  held: the nbr of each improved unit of this thread's first
    // tile (or -1) until the push
    int held[kDepth];
#pragma unroll
    for (int s = 0; s < kDepth; ++s) held[s] = -1;
    for (int t = blockIdx.x, j = 0; t < tiles; t += G, ++j) {
      int t0, t1;
      tile_of(t, t0, t1);
      const int u1 = min(t1, L);
      if (t0 >= u1) continue;
      int owner[kDepth], src[kDepth], nbr[kDepth];
      gather(t0, u1, owner, src, nbr);
      int before[kDepth], cand[kDepth];
#pragma unroll
      for (int s = 0; s < kDepth; ++s) {
        before[s] = 0;
        cand[s] = 0;
        if (owner[s] < 0) continue;
        before[s] = __ldcg(d.dist + nbr[s]);
        cand[s] = kChunks ? wrap_add(__ldcg(d.dist + src[s]), 1)
                          : cands[owner[s]];
      }
#pragma unroll
      for (int s = 0; s < kDepth; ++s) {
        const int u = t0 + s * kThreads + tid;
        int kept = -1;
        const int o = owner[s];
        if (o >= 0 && !(o < k && scan[o] > d.budget) && cand[s] < before[s]) {
          atomicMin(d.first_unit + nbr[s], stamp | static_cast<unsigned>(u));
          atomicMin(d.best + nbr[s], stamp | (static_cast<unsigned>(cand[s]) ^
                                             0x80000000u));
          kept = nbr[s];
        }
        if (j == 0) {
          held[s] = kept;
        } else if (o >= 0 && u < d.stored) {
          d.unit_nbr[u] = kept;
        }
      }
    }
    grid_barrier(d.barrier);

    // the next wavefront's lanes of the tasks already waiting in the ring:
    // a thread's first ring word goes out now, its loads after the dedup's,
    // its writes after the push
    const int head_after = wrap_add(head, k);
    const int waiting = wrap_sub(tail, head_after);
    const int free_slots = d.cap - waiting;
    const int wait_word = begin_waiting(head_after, waiting);
    LaneLoads wait_loads{0, 0, 0, 0ull, 0ull};

    // the candidates of this thread's units of tile t (j-th of the block)
    // for the dedup check: the held ones, the stored ones, or (per_item)
    // every unit's nbr found again
    auto candidates = [&](int j, int t0, int u1, int (&c)[kDepth]) {
      if (j == 0) {
#pragma unroll
        for (int s = 0; s < kDepth; ++s) c[s] = held[s];
      } else if (d.stored > 0) {
#pragma unroll
        for (int s = 0; s < kDepth; ++s) {
          const int u = t0 + s * kThreads + tid;
          c[s] = u < u1 ? d.unit_nbr[u] : -1;
        }
      } else {
        int owner[kDepth], src[kDepth];
        gather(t0, u1, owner, src, c);
      }
    };
    // whether unit t0 + s kThreads + tid is the one whose dedup word its
    // candidate holds: the candidate if so, else -1; and the best word
    auto dedup = [&](int t0, const int (&c)[kDepth], int (&kept)[kDepth],
                     unsigned long long (&bw)[kDepth]) {
      unsigned long long fu[kDepth];
#pragma unroll
      for (int s = 0; s < kDepth; ++s) {
        fu[s] = 0ull;
        bw[s] = 0ull;
        if (c[s] < 0) continue;
        fu[s] = __ldcg(d.first_unit + c[s]);
        bw[s] = __ldcg(d.best + c[s]);
      }
#pragma unroll
      for (int s = 0; s < kDepth; ++s) {
        const unsigned u = static_cast<unsigned>(t0 + s * kThreads + tid);
        kept[s] = c[s] >= 0 && fu[s] == (stamp | u) ? c[s] : -1;
      }
    };
    // The push of tile t: the thread's kept positions (bit s of `keep`)
    // with their tasks and lane data, ranked inside the tile by ballots and
    // placed after the round's earlier tiles by the look-back; a write at
    // or past free_slots is dropped.  Every thread of the block calls it.
    auto push_tile = [&](int t, unsigned keep, const int (&value)[kDepth],
                         const int (&off)[kDepth], const int (&end)[kDepth],
                         const int (&cand)[kDepth]) {
      unsigned ballot[kDepth];
#pragma unroll
      for (int s = 0; s < kDepth; ++s) {
        ballot[s] = __ballot_sync(kFull, (keep >> s) & 1u);
        if (lane == 0) step_count[s * kWarps + warp] = __popc(ballot[s]);
      }
      __syncthreads();
      if (warp == 0) {
        constexpr int kPer = kDepth * kWarps / 32;
        int c[kPer];
        int sum = 0;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          c[i] = step_count[lane * kPer + i];
          sum += c[i];
        }
        int incl = sum;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += y;
        }
        int excl = incl - sum;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          step_count[lane * kPer + i] = excl;
          excl += c[i];
        }
        const int kept = __shfl_sync(kFull, incl, 31);
        const Word stamped = static_cast<Word>(r) << 32;
        int base = 0;
        if (t > 0) {
          if (lane == 0) {
            store_word(d.status + t,
                       stamped | static_cast<unsigned>(kept));
          }
          base = look_back(d.status, t, r);
        }
        if (lane == 0) {
          store_word(d.status + t,
                     stamped | kPrefix |
                         static_cast<unsigned>(wrap_add(base, kept)));
          tile_base = base;
        }
      }
      __syncthreads();
      const unsigned below = (1u << lane) - 1u;
#pragma unroll
      for (int s = 0; s < kDepth; ++s) {
        if (!((keep >> s) & 1u)) continue;
        const int rank = wrap_add(
            tile_base,
            step_count[s * kWarps + warp] + __popc(ballot[s] & below));
        if (rank < free_slots) {
          d.buf[ring_slot(wrap_add(tail, rank), d.cap)] =
              lane_store<kPacked>(value[s]);
          if (waiting + rank < W) {
            d.lane_deg[waiting + rank] = wrap_sub(end[s], off[s]);
            d.lane_off[waiting + rank] = off[s];
            if constexpr (!kChunks) d.lane_cand[waiting + rank] = cand[s];
          }
        }
      }
      __syncthreads();  // step_count and tile_base serve the next tile
    };
    // The push of tile t whose units' tasks are `task` (or -1): the units
    // that push, then the truncated items past L, re-queued whole with the
    // degree and offset they were popped with.  At G = 1 a kept unit's
    // task is its nbr, whose next-round dist is its least cand (`bw`).  The
    // lane data's loads are in flight while the push is ranked.
    auto push = [&](int t, int t0, int t1, const int (&task)[kDepth],
                    const unsigned long long (&bw)[kDepth]) {
      unsigned keep = 0u;
      int value[kDepth], off[kDepth], end[kDepth], cand[kDepth];
#pragma unroll
      for (int s = 0; s < kDepth; ++s) {
        const int p = t0 + s * kThreads + tid;
        value[s] = 0;
        off[s] = 0;
        end[s] = 0;
        cand[s] = 0;
        if (p < L) {
          if (task[s] >= 0) {
            keep |= 1u << s;
            value[s] = task[s];
            lane_data(task[s], off[s], end[s]);
            if constexpr (!kChunks) cand[s] = wrap_add(best_value(bw[s]), 1);
          }
        } else if (p < t1) {
          const int l = p - L;
          if (scan[l] > d.budget) {
            keep |= 1u << s;
            value[s] = items[l];
            off[s] = offs[l];
            end[s] = wrap_add(offs[l],
                              wrap_sub(scan[l], l > 0 ? scan[l - 1] : 0));
            if constexpr (!kChunks) {
              const int v = clamp_to(items[l], 0, d.n - 1);
              cand[s] = next_cand(__ldcg(d.first_unit + v),
                                  __ldcg(d.best + v), __ldcg(d.dist + v),
                                  stamp);
            }
          }
        }
      }
      push_tile(t, keep, value, off, end, cand);
    };

    // 6-8. the unit that stays writes dist[nbr]; at G = 1 it pushes nbr
    for (int t = blockIdx.x, j = 0; t < tiles; t += G, ++j) {
      int t0, t1;
      tile_of(t, t0, t1);
      const int u1 = min(t1, L);
      int c[kDepth];
      if (t0 < u1) {
        candidates(j, t0, u1, c);
      } else {
#pragma unroll
        for (int s = 0; s < kDepth; ++s) c[s] = -1;
      }
      int kept[kDepth];
      unsigned long long bw[kDepth];
      dedup(t0, c, kept, bw);
      if (j == 0 && wait_lane < min(waiting, W)) {
        wait_loads = issue_lane(lane_load<kPacked>(wait_word), stamp);
      }
#pragma unroll
      for (int s = 0; s < kDepth; ++s) {
        if (kept[s] < 0) continue;
        d.dist[kept[s]] = best_value(bw[s]);
        if constexpr (kChunks) window_add(d.win, kept[s], cc, r);
      }
      if constexpr (kChunks) {
        // 7. the kept nbr waits for the window reads
        if (j == 0) {
#pragma unroll
          for (int s = 0; s < kDepth; ++s) held[s] = kept[s];
        } else if (d.stored > 0) {
#pragma unroll
          for (int s = 0; s < kDepth; ++s) {
            const int u = t0 + s * kThreads + tid;
            if (u < u1) d.unit_nbr[u] = kept[s];
          }
        }
      } else {
        push(t, t0, t1, kept, bw);
      }
    }
    if (blockIdx.x >= tiles && wait_lane < min(waiting, W)) {  // no tile
      wait_loads = issue_lane(lane_load<kPacked>(wait_word), stamp);
    }
    end_waiting(head_after, waiting, wait_loads, stamp);
    if constexpr (kChunks) {
      grid_barrier(d.barrier);
      // 7-8. the window reads: the chunk each kept unit pushes, then the
      // push
      for (int t = blockIdx.x, j = 0; t < tiles; t += G, ++j) {
        int t0, t1;
        tile_of(t, t0, t1);
        const int u1 = min(t1, L);
        int task[kDepth];
#pragma unroll
        for (int s = 0; s < kDepth; ++s) task[s] = -1;
        if (t0 < u1) {
          if (j == 0 || d.stored > 0) {
            candidates(j, t0, u1, task);
          } else {
            int c[kDepth];
            unsigned long long bw[kDepth];
            candidates(j, t0, u1, c);
            dedup(t0, c, task, bw);
          }
        }
        unsigned long long none[kDepth];
#pragma unroll
        for (int s = 0; s < kDepth; ++s) {
          if (task[s] >= 0) task[s] = window_emit(d.win, task[s], cc, true);
          none[s] = 0ull;
        }
        push(t, t0, t1, task, none);
      }
    }
    // block 0 keeps the round's work, the widths of the chunks not
    // truncated, while the other blocks push
    int round_work = 0;
    if (blockIdx.x == 0) {
      int work_local = 0;
      for (int l = tid; l < k; l += kThreads) {
        if (scan[l] <= d.budget) work_local += chunk_width(items[l], cc);
      }
      round_work = block_sum<kThreads>(work_local, warp_sums);
    }
    grid_barrier(d.barrier);
    preload(head_after);

    // 9. cursors and counters, the same in every block; the round's push
    // count is the last tile's inclusive prefix
    const int count = static_cast<int>(
        __ldcg(d.status + tiles - 1) & 0x7fffffffull);
    const int pushed = count < free_slots ? count : free_slots;
    tracer.record(d.trace, kChunks ? d.win.splits : nullptr, rounds, size,
                  k, pushed, round_work);
    dropped = wrap_add(dropped, wrap_sub(count, pushed));
    tail = wrap_add(tail, pushed);
    head = head_after;
    work = wrap_add(work, round_work);
    processed = wrap_add(processed, k);
    rounds += 1;
    counter_rounds = wrap_add(counter_rounds, 1);
  }

  if (blockIdx.x == 0 && tid == 0) {
    d.cursors[kHead] = head;
    d.cursors[kTail] = tail;
    d.cursors[kDropped] = dropped;
    d.cursors[kRounds] = rounds;
    d.cursors[kProcessed] = processed;
    d.cursors[kWork] = work;
    // the split windows were counted with atomics before the last barrier
    d.cursors[kSplits] = wrap_add(splits, static_cast<int>(__ldcg(d.win.splits)));
    d.cursors[kCounterRounds] = counter_rounds;
    *d.units = units;
  }
  tracer.end(d.trace);
}

// The instance of a granularity and mode.
template <bool kChunks, bool kPacked, bool kSlotted>
const void* instance(bool traced) {
  return traced ? reinterpret_cast<const void*>(
                      bfs_drain<kChunks, kPacked, true, kSlotted>)
                : reinterpret_cast<const void*>(
                      bfs_drain<kChunks, kPacked, false, kSlotted>);
}

template <bool kSlotted>
const void* instance_of(int granularity, bool packed, bool traced) {
  if (granularity > 1) {
    return packed ? instance<true, true, kSlotted>(traced)
                  : instance<true, false, kSlotted>(traced);
  }
  return packed ? instance<false, true, kSlotted>(traced)
                : instance<false, false, kSlotted>(traced);
}

const void* kernel_for(int granularity, bool packed, bool traced,
                       bool slotted) {
  return slotted ? instance_of<true>(granularity, packed, traced)
                 : instance_of<false>(granularity, packed, traced);
}

// The launch plan for a wavefront of W at granularity G in a mode: dynamic
// shared memory (0 when the wavefront goes to global scratch) and the
// co-resident grid of that instance.
cudaError_t plan(int W, int granularity, bool packed, bool traced,
                 bool slotted, size_t* dyn, int* grid) {
  const void* kernel = kernel_for(granularity, packed, traced, slotted);
  DeviceInfo info;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const size_t wave = kWaveArrays * static_cast<size_t>(W) * sizeof(int);
  *dyn = wave + attr.sharedSizeBytes <= static_cast<size_t>(info.smem_optin)
             ? wave
             : 0;
  return cooperative_grid(kernel, kThreads, *dyn, grid);
}

}  // namespace

// The grid the launch takes for a wavefront of W at granularity G in a mode
// (packed: the fused mode; traced: the traced mode; slotted: the slotted
// mode), and whether the wavefront lives in shared memory (1) or in global
// scratch of grid * 4 W ints (0).  Returns the cudaError_t (0 on success).
extern "C" int bfs_drain_grid(int wavefront, int granularity, int packed,
                              int traced, int slotted, int* grid,
                              int* wave_in_shared) {
  size_t dyn = 0;
  const cudaError_t err = plan(wavefront, granularity, packed != 0,
                               traced != 0, slotted != 0, &dyn, grid);
  if (err != cudaSuccess) return err;
  *wave_in_shared = dyn > 0;
  return cudaSuccess;
}

// The most push positions of one tile: a round of P positions takes
// max(grid, ceil(P / this)) status words at most.
extern "C" int bfs_drain_tile_positions() { return kPass; }

// One cooperative launch of the whole drain on `stream`.  `grid` and
// `wave_global` come from bfs_drain_grid; the scratch is sized by the caller
// (unit_nbr: `stored` ints, `stored` being budget for merge path and 0 for
// per_item, whose budget is INT_MAX; first_unit and best: n words of all
// ones each; windows: 3 (n / G + 2) zeroed words, then one zeroed split
// count; lane_deg, lane_off and lane_cand: W ints each; status: tiles_cap
// zeroed 64-bit words, at least max(grid, ceil((the round's most units + W)
// / bfs_drain_tile_positions())), or the launch traps; barrier: one zeroed
// word; units: one word, which gets the number of work units the drain
// expanded).  `threshold` is the split threshold (INT_MAX for none).
// `packed` selects the fused mode (buf is lane 0 of a one-lane
// MultiQueue); a non-null `trace` the traced mode, with its
// [trace_capacity][13] rows and one-int cursor, both updated in place; a
// non-null `slab_ptr` the slotted mode, where col_idx is the slab array of m
// words and slab_len, ovl_ptr and ovl_col the rest of the slotted view.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int bfs_drain_launch(
    int* buf, int cap, int* dist, int n, const int* row_ptr,
    const int* col_idx, int m, const int* slab_ptr, const int* slab_len,
    const int* ovl_ptr, const int* ovl_col, int* cursors, int wavefront,
    int budget, int stored, int max_rounds, int granularity, int width_bits,
    int threshold, int* unit_nbr, unsigned long long* first_unit,
    unsigned long long* best, unsigned long long* windows,
    unsigned int* splits, int* lane_deg, int* lane_off, int* lane_cand,
    unsigned long long* status, int tiles_cap, unsigned int* barrier,
    int* wave_global, long long* units, int packed, int* trace,
    int trace_capacity, int* trace_cursor, int grid, cudaStream_t stream) {
  size_t dyn = 0;
  int most = 0;
  const bool traced = trace != nullptr;
  const bool slotted = slab_ptr != nullptr;
  if (granularity < 1 || granularity > 64) return cudaErrorInvalidValue;
  if (traced && (trace_capacity < 1 || trace_cursor == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (slotted && (slab_len == nullptr || ovl_ptr == nullptr ||
                  ovl_col == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = plan(wavefront, granularity, packed != 0, traced, slotted,
                         &dyn, &most);
  if (err != cudaSuccess) return err;
  if (grid < 1 || grid > most || tiles_cap < grid) {
    return cudaErrorInvalidValue;
  }
  if ((dyn == 0) != (wave_global != nullptr)) return cudaErrorInvalidValue;
  const size_t nb = static_cast<size_t>(n / granularity + 2);
  Drain d{};
  d.buf = buf;
  d.cap = cap;
  d.dist = dist;
  d.n = n;
  d.row_ptr = row_ptr;
  d.col_idx = col_idx;
  d.m = m;
  d.slotted = Slotted{slab_ptr, slab_len, ovl_ptr, ovl_col};
  d.cursors = cursors;
  d.wavefront = wavefront;
  d.budget = budget;
  d.stored = stored;
  d.max_rounds = max_rounds;
  d.codec = Codec{granularity, width_bits};
  d.win = Windows{windows, windows + nb, windows + 2 * nb, splits, row_ptr,
                  n, threshold};
  d.unit_nbr = unit_nbr;
  d.first_unit = first_unit;
  d.best = best;
  d.lane_deg = lane_deg;
  d.lane_off = lane_off;
  d.lane_cand = lane_cand;
  d.status = status;
  d.tiles_cap = tiles_cap;
  d.barrier = barrier;
  d.wave_global = wave_global;
  d.units = units;
  d.trace = TraceRing{trace, trace_capacity, trace_cursor};
  void* args[] = {&d};
  err = cudaLaunchCooperativeKernel(
      kernel_for(granularity, packed != 0, traced, slotted), dim3(grid),
      dim3(kThreads), args, dyn, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
