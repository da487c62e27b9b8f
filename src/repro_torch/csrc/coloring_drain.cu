// Speculative greedy coloring's whole drain in one cooperative launch,
// kernel B3-col.
//
// Replaces the TPU kernel `make_fused_drain` / `fused_drain_pallas`
// (pallas_call at src/repro/kernels/drain_loop/kernel.py:121) for the
// coloring program at every granularity 1 <= G <= 64.  It computes exactly
// what the port's plain fused drain (`fused_drain_ref` over
// `wavefront_step` with the fused assign/detect body) computes, while
//
//   rounds < min(max_rounds, limit) and tail - head > 0:
//
//   1. pop      items[l] = buf[(head + l) % cap] for l < k = min(size, W);
//               +(c + 1) assigns the chunk c, -(c + 1) detects it
//               (drain_common.cuh's codec); the k chunks explode into k G
//               vertex lanes, lane l G + j holding head + j for j < width,
//               as core/task.flatten_chunks lays them out;
//   2. pick     for every assign vertex v: the smallest color in [0, deg(v)]
//               that no neighbor holds, read from the round-start colors
//               (all picks are made before any is committed);
//   3. commit   colors[v] = pick;
//   4. detect   for every detect vertex v: v re-colors if a neighbor u holds
//               v's (post-commit) color and wins the (hash, id) order; at
//               G > 1 the vertices that re-color coalesce into chunks over
//               G-aligned windows (window_add / window_emit, one more grid
//               barrier);
//   5. push     [-(c + 1) of every assign chunk, wavefront order] ++
//               [+(c' + 1) of every re-assign chunk c', vertex-lane order]
//               into the ring at tail + rank (ranks from prefix sums), the
//               excess dropped;
//   6. counters work += assign vertices, splits += the windows split,
//               processed += k, rounds and the WorkCounter's rounds += 1.
//
// A vertex has at most one task in the queue, so a round's vertex lanes
// are distinct vertices and the commits have unique targets.
//
// Load-balanced visits.  Every block holds the popped items and S, the
// inclusive scan of its vertex lanes' degrees (0 for a lane without a
// vertex), in shared memory.  The degrees are read from row_ptr once in the
// grid, into lane_deg: the first wavefront's before the launch's first grid
// barrier, each next one's during the push (the tasks already waiting in
// the ring in the push-count phase, each pushed task by the thread that
// writes it), so a block's pop reads them back coalesced.  The round's
// V = S[W G - 1] neighbor visits are cut into equal contiguous slices, one
// a warp of the grid, whatever the rows' lengths: a warp finds the lane of
// its first visit by a search of S and walks the slice 128 visits a step,
// each thread finding its visits' lanes by galloping searches from the
// step's first lane.  No row, however long, rests on one warp or one block.
// Pick and detect are order-independent, so the slices may split a row
// anywhere:
//
//   * the pick's forbidden colors are a bitset in global scratch, deg + 1
//     bits a lane, lane f's words from f + (S[f - 1] / 32) (disjoint, and
//     W G + V / 32 words in all, at most the program's degree budget / 32 +
//     W G).  A warp merges its step's bits by (lane, word) (match and
//     reduce), keeps the bits of the row its step ends in in shared memory
//     while the row goes on, the warps of a block that end in one row merge
//     theirs, and only then are they ORed into global memory: at most one
//     atomicOr per (warp, lane, word), none per visit;
//   * after a grid barrier every read of the round-start colors is done, so
//     the pass that finds a lane's first free bit commits colors[v] at once
//     (a thread a lane, its warp for a lane whose first 32 colors are all
//     taken);
//   * the detects walk the same slices on the post-commit colors and mark a
//     lane that re-colors with a plain store of 1; in the same phase the
//     grid zeroes the round's bitset words, so the scratch is clean without
//     a memset; the push reads each mark and sets it back to 0.
//
// Five grid barriers a round (six at G > 1): after the ORs, after the
// commits, after the detects, (after the window adds,) after the push
// counts and after the ring write.  Structure, barriers and the push are
// drain_common.cuh's.
//
// Modes.  The fused mode (B3-fused) drains lane 0 of the fused topology's
// one-lane MultiQueue: a popped word is unpacked to its task and a pushed
// task packed with job 0 (drain_common.cuh's lane_load / lane_store), which
// is what runtime/api.fused_lane_ops does around the same body.  The traced
// mode (B3-traced) writes one trace row a round from block 0 after the
// round's last barrier (drain_common.cuh's Tracer).  The slotted mode
// (B3-slotted) drains a streaming graph's slotted view: col_idx is its slab
// array, and the j-th neighbor of a row is its slab or overlay word at
// offset j (drain_common.cuh's Slotted).  Each mode is a template argument,
// so the single, untraced, canonical instances are unchanged.
//
// What bounds the drain on an H100: bytes, 8 per neighbor visited (its
// col_idx word and its color) for every assign and every detect, and the
// barriers.

#include <cuda_runtime.h>

#include "drain_common.cuh"

namespace {

using namespace drain;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVisits = 4;              // visits a thread takes a step
constexpr int kStep = 32 * kVisits;     // visits a warp takes a step
constexpr int kBatch = 8;               // words a thread pops at a time

struct Drain {
  int* buf;  // [cap] the task ring, updated in place
  int cap;
  int* colors;  // [n] updated in place
  int n;
  const int* row_ptr;  // [n + 1]
  const int* col_idx;  // [m]; the slab array in the slotted mode
  Slotted slotted;     // the slotted mode's slab and overlay arrays
  int* cursors;        // [kCursors]
  int wavefront;
  int max_rounds;
  Codec codec;
  Windows win;    // the re-assigns' chunk windows
  int* bad;       // [W G] a detect lane's mark, then what it pushes plus
                  // one; zero between rounds
  unsigned* bits;  // [bits_cap] the forbidden-color bitsets; zero between
                   // rounds
  int bits_cap;
  int* lane_deg;   // [W G] the degree of each vertex lane of the next
                   // round's wavefront (0 for none)
  int* block_count;       // [gridDim.x] push count of each block
  unsigned int* barrier;  // [1] the grid barrier's arrivals; zero at launch
  int* wave_global;  // [gridDim.x][W (1 + G)] when the wavefront and its
                     // degree scan do not fit in shared memory, else null
  long long* visits;  // out: neighbors visited by the picks and detects
  TraceRing trace;    // the traced mode's ring
};

// The reference's uint32 priority hash.
__device__ __forceinline__ unsigned priority(unsigned v) {
  unsigned h = (v * 2654435761u) ^ 0x9E3779B9u;
  h = (h ^ (h >> 13)) * 0x85EBCA6Bu;
  return h ^ (h >> 16);
}

// Does u win against v in the (hash, id) order, so that v re-colors?
__device__ __forceinline__ bool beats(int u, unsigned pu, int v,
                                      unsigned pv) {
  return pu < pv || (pu == pv && u < v);
}

// Word w of a forbidden bitset over colors [0, deg], flipped to "free",
// with the bits past deg cleared.
__device__ __forceinline__ unsigned free_bits(unsigned word, int w, int deg) {
  unsigned f = ~word;
  const int lim = deg - w * 32;  // the last valid bit of this word
  if (lim < 31) f &= (lim < 0) ? 0u : ((1u << (lim + 1)) - 1u);
  return f;
}

// The chunk code of a task: c for +(c + 1) and -(c + 1).
__device__ __forceinline__ int code_of(int item) {
  return item > 0 ? item - 1 : wrap_sub(-1, item);
}

// The j-th neighbor of row v, whose canonical run starts at lo.
template <bool kSlotted>
__device__ __forceinline__ int neighbor(const Drain& d, int lo, int v, int j) {
  if constexpr (kSlotted) {
    return slotted_word(d.slotted, d.col_idx, v, j);
  } else {
    return __ldg(d.col_idx + lo + j);
  }
}

// The first j >= f with s[j] > q, where every j < f has s[j] <= q and
// some j < n has s[j] > q: a galloping search, O(log) of the distance.
__device__ __forceinline__ int owner_from(const int* s, int n, int f, int q) {
  int lo = f;
  int step = 1;
  int hi = n;
  while (lo < n) {
    const int p = min(lo + step - 1, n - 1);
    if (s[p] > q) {
      hi = p;
      break;
    }
    lo = p + 1;
    step <<= 1;
  }
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] > q) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// Two blocks an SM where shared memory allows: at most 64 registers a
// thread.  kChunks = false is the G = 1 instance, whose codec is the
// compile-time identity: no division by G, no window code.  kPacked is the
// fused mode, kTraced the traced mode, kSlotted the slotted mode.
template <bool kChunks, bool kPacked, bool kTraced, bool kSlotted>
__global__ void __launch_bounds__(kThreads, 2) coloring_drain(Drain d) {
  extern __shared__ int dyn[];
  __shared__ unsigned acc[kWarps][32];  // each warp's bits of an open row
  __shared__ int open_row[kWarps];      // the row of each warp's acc
  __shared__ int warp_sums[kWarps];
  const int W = d.wavefront;
  const Codec cc = kChunks ? d.codec : Codec{1, 0};
  const int WG = W * cc.G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = gridDim.x;
  const int gwarp = blockIdx.x * kWarps + warp;
  const int n_warps = G * kWarps;
  int* items = d.wave_global
                   ? d.wave_global + static_cast<size_t>(blockIdx.x) * (W + WG)
                   : dyn;
  int* S = items + W;  // [W G] the inclusive scan of the lanes' degrees

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
  acc[warp][lane] = 0u;

  // the degrees of the vertex lanes of wavefront lane l, whose task is
  // item, into lane_deg: each is computed once in the grid, by the thread
  // that has the task, before the grid barrier that precedes the pop
  auto put_degrees = [&](int l, int item) {
    const int c = code_of(item);
    const int h = chunk_head(c, cc);
    const int width = chunk_width(c, cc);
    for (int j = 0; j < cc.G; ++j) {
      d.lane_deg[l * cc.G + j] =
          j < width ? __ldg(d.row_ptr + h + j + 1) - __ldg(d.row_ptr + h + j)
                    : 0;
    }
  };
  const int gthread = blockIdx.x * kThreads + tid;
  const int n_threads = G * kThreads;
  for (int l = gthread; l < min(wrap_sub(tail, head), W); l += n_threads) {
    put_degrees(l, lane_load<kPacked>(
                       __ldcg(d.buf + ring_slot(wrap_add(head, l), d.cap))));
  }
  // every block has read the cursors before block 0 may write them back
  grid_barrier(d.barrier);

  int K = 0;  // vertex lanes in play this round
  // the vertex of vertex lane f
  auto vertex_of = [&](int f) {
    return chunk_head(code_of(items[f / cc.G]), cc) + f % cc.G;
  };
  // 1 for an assign vertex lane, -1 for a detect one, 0 for no vertex
  auto kind_of = [&](int f) {
    if (f >= K) return 0;
    const int item = items[f / cc.G];
    if (kChunks && f % cc.G >= chunk_width(code_of(item), cc)) return 0;
    return item > 0 ? 1 : -1;
  };
  auto before = [&](int f) { return f > 0 ? S[f - 1] : 0; };
  // the first bitset word of lane f
  auto word_of = [&](int f) { return f + before(f) / 32; };

  // Walk this warp's slice of the round's visits, those of the lanes of
  // kind `want` (the lanes of the other kind are stepped over), 128 a
  // step: stepped(f_last) with the lane of the step's last visit, then
  // visit(fs, js, oks) with the thread's kVisits visits of the step, visit
  // i of lane fs[i] at offset js[i] (oks[i] false past the slice or on
  // another kind's lane), so that their loads can all be in flight at
  // once.  Every lane of the warp takes every call.
  auto walk = [&](int V, int want, auto visit, auto stepped) {
    const long long all = V;
    const long long per = (all + n_warps - 1) / n_warps;
    const int s0 = static_cast<int>(min(per * gwarp, all));
    const int s1 = static_cast<int>(min(per * (gwarp + 1), all));
    if (s0 >= s1) return;
    int x = s0;
    int f = upper_bound(S, WG, x);
    while (true) {
      while (x < s1 && kind_of(f) != want) {  // a lane of the other kind
        x = S[f];
        if (x < s1) f = owner_from(S, WG, f + 1, x);
      }
      if (x >= s1) break;
      const int end = min(x + kStep, s1);
      const int f_last = owner_from(S, WG, f, end - 1);
      stepped(f_last);
      int fs[kVisits], js[kVisits];
      bool oks[kVisits];
#pragma unroll
      for (int i = 0; i < kVisits; ++i) {
        const int q = x + lane + 32 * i;
        const bool in = q < end;
        fs[i] = in ? owner_from(S, WG, f, q) : f;
        js[i] = q - before(fs[i]);
        oks[i] = in && kind_of(fs[i]) == want;
      }
      visit(fs, js, oks);
      x = end;
      if (x < s1) f = owner_from(S, WG, f_last, x);
    }
  };

  long long visits = 0;
  while (rounds < d.max_rounds && rounds < limit && wrap_sub(tail, head) > 0) {
    const int size = wrap_sub(tail, head);
    const int k = size < W ? size : W;
    K = k * cc.G;
    const unsigned r = static_cast<unsigned>(rounds) + 1u;

    // 1. pop, the vertex lanes' degrees (0 for none, from lane_deg)
    // scanned into S, the assign vertices; neighbouring threads read
    // neighbouring words, kBatch loads a thread in flight together
    int assign_local = 0;
    for (int l = tid; l < W; l += kBatch * kThreads) {
      int item[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int at = l + i * kThreads;
        item[i] = at < k ? lane_load<kPacked>(__ldcg(
                               d.buf + ring_slot(wrap_add(head, at), d.cap)))
                         : kEmpty;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int at = l + i * kThreads;
        if (at < W) items[at] = item[i];
        if (item[i] > 0) assign_local += chunk_width(code_of(item[i]), cc);
      }
    }
    for (int f = tid; f < WG; f += kBatch * kThreads) {
      int deg[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int at = f + i * kThreads;
        deg[i] = at < K ? __ldcg(d.lane_deg + at) : 0;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (f + i * kThreads < WG) S[f + i * kThreads] = deg[i];
      }
    }
    __syncthreads();
    scan_lanes<kThreads>(S, WG, warp_sums);
    const int n_assign = block_sum<kThreads>(assign_local, warp_sums);
    const int V = S[WG - 1];
    // distinct vertices keep the bitsets inside the degree budget
    if (WG + V / 32 > d.bits_cap) __trap();

    // 2. the forbidden colors of each assign lane, from the round-start
    // colors: each warp's slice, its bits merged by (lane, word), the bits
    // of the row its step ends in kept in acc while the row goes on
    int f_open = -1;
    auto flush = [&]() {
      if (f_open >= 0) {
        const unsigned word = acc[warp][lane];
        if (word) atomicOr(d.bits + word_of(f_open) + lane, word);
        acc[warp][lane] = 0u;
      }
      __syncwarp();
    };
    walk(
        V, 1,
        [&](const int(&fs)[kVisits], const int(&js)[kVisits],
            const bool(&oks)[kVisits]) {
          int u[kVisits];
          int c[kVisits];
#pragma unroll
          for (int i = 0; i < kVisits; ++i) {
            const int v = vertex_of(fs[i]);
            u[i] = oks[i] ? neighbor<kSlotted>(d, __ldg(d.row_ptr + v), v,
                                               js[i])
                          : 0;
          }
#pragma unroll
          for (int i = 0; i < kVisits; ++i) {
            c[i] = oks[i] ? __ldcg(d.colors + u[i]) : -1;
          }
#pragma unroll
          for (int i = 0; i < kVisits; ++i) {
            const int f = fs[i];
            const bool hit = oks[i] && c[i] >= 0 && c[i] <= S[f] - before(f);
            visits += oks[i];
            if (!__any_sync(kFull, hit)) continue;
            // (lane, word) in 32 bits for words below 64; a word past them
            // and a lane without a hit take keys of their own
            const unsigned key =
                hit && (c[i] >> 5) < 64
                    ? (static_cast<unsigned>(f) << 6) |
                          static_cast<unsigned>(c[i] >> 5)
                    : (hit ? 0xC0000000u : 0x80000000u) | lane;
            const unsigned group = __match_any_sync(kFull, key);
            const unsigned word =
                __reduce_or_sync(group, hit ? 1u << (c[i] & 31) : 0u);
            if (hit && lane == __ffs(group) - 1) {
              if (f == f_open && (c[i] >> 5) < 32) {
                acc[warp][c[i] >> 5] |= word;
              } else {
                atomicOr(d.bits + word_of(f) + (c[i] >> 5), word);
              }
            }
            __syncwarp();
          }
        },
        [&](int f_last) {
          if (f_last != f_open) {
            flush();
            f_open = kind_of(f_last) == 1 ? f_last : -1;
          }
        });
    // the rows still open: warps of the block that end in one row merge
    // their words, so a row that spans the block costs one atomicOr a word
    if (lane == 0) open_row[warp] = f_open;
    __syncthreads();
    if (f_open >= 0 && (warp == 0 || open_row[warp - 1] != f_open)) {
      unsigned word = 0u;
      for (int w = warp; w < kWarps && open_row[w] == f_open; ++w) {
        word |= acc[w][lane];
      }
      if (word) atomicOr(d.bits + word_of(f_open) + lane, word);
    }
    __syncthreads();
    acc[warp][lane] = 0u;
    grid_barrier(d.barrier);

    // 3. each assign lane's first free color, committed at once: a thread
    // a lane reads its first word; a lane whose first 32 colors are all
    // taken is searched by its warp, 32 words a step
    for (int base = gwarp * 32; base < K; base += n_warps * 32) {
      const int f = base + lane;
      const bool mine = kind_of(f) == 1;
      const int deg = mine ? S[f] - before(f) : 0;
      const int at = mine ? word_of(f) : 0;
      int pick = -1;
      if (mine) {
        const unsigned fr = free_bits(__ldcg(d.bits + at), 0, deg);
        if (fr) pick = __ffs(fr) - 1;
      }
      unsigned more = __ballot_sync(kFull, mine && pick < 0);
      while (more) {
        const int src = __ffs(more) - 1;
        more &= more - 1;
        const int sdeg = __shfl_sync(kFull, deg, src);
        const int sat = __shfl_sync(kFull, at, src);
        const int words = sdeg / 32 + 1;
        int found = -1;
        for (int w0 = 1; w0 < words && found < 0; w0 += 32) {
          const int w = w0 + lane;
          const unsigned fr =
              w < words ? free_bits(__ldcg(d.bits + sat + w), w, sdeg) : 0u;
          const unsigned has = __ballot_sync(kFull, fr != 0u);
          if (has) {
            const int first = __ffs(has) - 1;
            const unsigned ff = __shfl_sync(kFull, fr, first);
            found = (w0 + first) * 32 + __ffs(ff) - 1;
          }
        }
        if (lane == src) pick = found;
      }
      if (mine) d.colors[vertex_of(f)] = pick;
    }
    grid_barrier(d.barrier);

    // 4. detects on the post-commit colors over the same slices, a lane
    // that re-colors marked with a 1; the round's bitset words zeroed
    walk(
        V, -1,
        [&](const int(&fs)[kVisits], const int(&js)[kVisits],
            const bool(&oks)[kVisits]) {
          int v[kVisits];
          int my[kVisits];
          int u[kVisits];
#pragma unroll
          for (int i = 0; i < kVisits; ++i) {
            v[i] = vertex_of(fs[i]);
            my[i] = oks[i] ? __ldcg(d.colors + v[i]) : -1;
            u[i] = oks[i] ? neighbor<kSlotted>(d, __ldg(d.row_ptr + v[i]),
                                               v[i], js[i])
                          : 0;
          }
#pragma unroll
          for (int i = 0; i < kVisits; ++i) {
            const int cu = oks[i] ? __ldcg(d.colors + u[i]) : -1;
            if (my[i] < 0) continue;
            visits += 1;
            if (cu == my[i] &&
                beats(u[i], priority(static_cast<unsigned>(u[i])), v[i],
                      priority(static_cast<unsigned>(v[i])))) {
              d.bad[fs[i]] = 1;
            }
          }
        },
        [](int) {});
    const int words = WG + V / 32;
    for (int w = (blockIdx.x * kThreads + tid) * 4; w < words;
         w += G * kThreads * 4) {
      if (w + 4 <= words) {
        *reinterpret_cast<uint4*>(d.bits + w) = make_uint4(0u, 0u, 0u, 0u);
      } else {
        for (int i = w; i < min(w + 4, words); ++i) d.bits[i] = 0u;
      }
    }
    grid_barrier(d.barrier);

    // at G > 1 each marked vertex joins its window, one pass, then a
    // barrier before the windows are read
    int lo, hi;
    if (kChunks) {
      block_range(K, blockIdx.x, G, lo, hi);
      for (int f = lo + tid; f < hi; f += kThreads) {
        if (kind_of(f) == -1 && __ldcg(d.bad + f)) {
          window_add(d.win, vertex_of(f), cc, r);
        }
      }
      grid_barrier(d.barrier);
    }

    // 5. push: positions [0, k) the assigns' detects, [k, k + K) the
    // re-assigns by vertex lane; a marked lane's push (v + 1 at G = 1, its
    // window's chunk plus one at G > 1) replaces its mark
    const int P = k + K;
    block_range(P, blockIdx.x, G, lo, hi);
    int kept_local = 0;
    for (int p = lo + tid; p < hi; p += kThreads) {
      if (p < k) {
        kept_local += items[p] > 0;
        continue;
      }
      const int f = p - k;
      if (kind_of(f) != -1 || !__ldcg(d.bad + f)) continue;
      int value = vertex_of(f) + 1;
      if (cc.G > 1) {
        const int chunk = window_emit(d.win, vertex_of(f), cc, true);
        value = chunk >= 0 ? chunk + 1 : 0;
      }
      d.bad[f] = value;
      kept_local += value != 0;
    }
    // the next wavefront's lane degrees: of the tasks already in the ring
    // here, of the pushed ones as they are written
    const int head_after = wrap_add(head, k);
    const int waiting = wrap_sub(tail, head_after);
    for (int l = gthread; l < min(waiting, W); l += n_threads) {
      put_degrees(l, lane_load<kPacked>(__ldcg(
                         d.buf + ring_slot(wrap_add(head_after, l), d.cap))));
    }
    const int kept = block_sum<kThreads>(kept_local, warp_sums);
    if (tid == 0) d.block_count[blockIdx.x] = kept;
    grid_barrier(d.barrier);

    const int free_slots = d.cap - wrap_sub(tail, head_after);
    const int count = ring_push<kThreads, kPacked>(
        d.buf, d.cap, tail, free_slots, d.block_count, lo, hi, warp_sums,
        [&](int p, int& value) {
          if (p < k) {
            value = wrap_sub(0, items[p]);  // -(c + 1) for an assign
            return items[p] > 0;
          }
          const int f = p - k;
          value = kind_of(f) == -1 ? __ldcg(d.bad + f) : 0;
          if (value) d.bad[f] = 0;  // clean for the next round
          return value != 0;
        },
        [&](int rank, int task) {
          if (waiting + rank < W) put_degrees(waiting + rank, task);
        });
    grid_barrier(d.barrier);

    // 6. cursors and counters, the same in every block
    const int pushed = count < free_slots ? count : free_slots;
    tracer.record(d.trace, kChunks ? d.win.splits : nullptr, rounds, size,
                  k, pushed, n_assign);
    dropped = wrap_add(dropped, wrap_sub(count, pushed));
    tail = wrap_add(tail, pushed);
    head = head_after;
    work = wrap_add(work, n_assign);
    processed = wrap_add(processed, k);
    rounds += 1;
    counter_rounds = wrap_add(counter_rounds, 1);
  }

  // the visits of every thread that counted some, summed into one word
  if (visits) atomicAdd(reinterpret_cast<unsigned long long*>(d.visits),
                        static_cast<unsigned long long>(visits));
  if (blockIdx.x == 0 && tid == 0) {
    d.cursors[kHead] = head;
    d.cursors[kTail] = tail;
    d.cursors[kDropped] = dropped;
    d.cursors[kRounds] = rounds;
    d.cursors[kProcessed] = processed;
    d.cursors[kWork] = work;
    // the split windows were counted with atomics before the last barrier
    d.cursors[kSplits] =
        wrap_add(splits, static_cast<int>(__ldcg(d.win.splits)));
    d.cursors[kCounterRounds] = counter_rounds;
  }
  tracer.end(d.trace);
}

// The instance of a granularity and mode.
template <bool kChunks, bool kPacked, bool kSlotted>
const void* instance(bool traced) {
  return traced ? reinterpret_cast<const void*>(
                      coloring_drain<kChunks, kPacked, true, kSlotted>)
                : reinterpret_cast<const void*>(
                      coloring_drain<kChunks, kPacked, false, kSlotted>);
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

// The launch plan for a wavefront of W chunks of up to G vertices in a
// mode: dynamic shared memory and the co-resident grid.  The wavefront and
// its vertex lanes' degree scan go to global scratch when they do not fit
// in shared memory.
cudaError_t plan(int W, int granularity, bool packed, bool traced,
                 bool slotted, size_t* dyn, bool* wave_shared, int* grid) {
  const void* kernel = kernel_for(granularity, packed, traced, slotted);
  DeviceInfo info;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const size_t optin = static_cast<size_t>(info.smem_optin);
  const size_t wave =
      static_cast<size_t>(W) * (1 + granularity) * sizeof(int);
  *wave_shared = wave + attr.sharedSizeBytes <= optin;
  *dyn = *wave_shared ? wave : 0;
  return cooperative_grid(kernel, kThreads, *dyn, grid);
}

}  // namespace

// The grid the launch takes for a wavefront of W chunks of up to G
// vertices in a mode (packed: the fused mode; traced: the traced mode;
// slotted: the slotted mode), and whether the wavefront lives in shared
// memory (1) or in global scratch of grid * W (1 + G) ints (0).  Returns
// the cudaError_t (0 on success).
extern "C" int coloring_drain_grid(int wavefront, int granularity,
                                   int packed, int traced, int slotted,
                                   int* grid, int* wave_in_shared) {
  size_t dyn = 0;
  bool shared = false;
  const cudaError_t err =
      plan(wavefront, granularity, packed != 0, traced != 0, slotted != 0,
           &dyn, &shared, grid);
  if (err != cudaSuccess) return err;
  *wave_in_shared = shared;
  return cudaSuccess;
}

// One cooperative launch of the whole drain on `stream`.  `grid` and
// `wave_global` come from coloring_drain_grid; the scratch is sized by the
// caller: bad W G ints and bits bits_cap words, both zero on entry and left
// zero (bits_cap at least W G + (the largest degree sum of W G distinct
// vertices) / 32, or the launch traps); lane_deg W G ints; windows 3
// (n / G + 2) zeroed
// words, then one zeroed split count; block_count grid ints; barrier one
// zeroed word; visits one zeroed word, which gets the neighbors the picks
// and detects visited.  `threshold` is the split threshold (INT_MAX for
// none).  `packed` selects the fused mode (buf is lane 0 of a one-lane
// MultiQueue); a non-null `trace` the traced mode, with its
// [trace_capacity][13] rows and one-int cursor, both updated in place; a
// non-null `slab_ptr` the slotted mode, where col_idx is the slab array and
// slab_len, ovl_ptr and ovl_col the rest of the slotted view.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int coloring_drain_launch(
    int* buf, int cap, int* colors, int n, const int* row_ptr,
    const int* col_idx, const int* slab_ptr, const int* slab_len,
    const int* ovl_ptr, const int* ovl_col, int* cursors, int wavefront,
    int max_rounds, int granularity, int width_bits, int threshold,
    int* bad, unsigned* bits, int bits_cap, int* lane_deg,
    unsigned long long* windows,
    unsigned int* splits, int* block_count, unsigned int* barrier,
    int* wave_global, long long* visits, int packed, int* trace,
    int trace_capacity, int* trace_cursor, int grid, cudaStream_t stream) {
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
  size_t dyn = 0;
  bool shared = false;
  int most = 0;
  cudaError_t err = plan(wavefront, granularity, packed != 0, traced, slotted,
                         &dyn, &shared, &most);
  if (err != cudaSuccess) return err;
  if (grid < 1 || grid > most) return cudaErrorInvalidValue;
  if (shared != (wave_global == nullptr)) return cudaErrorInvalidValue;
  const size_t nb = static_cast<size_t>(n / granularity + 2);
  Drain d{};
  d.buf = buf;
  d.cap = cap;
  d.colors = colors;
  d.n = n;
  d.row_ptr = row_ptr;
  d.col_idx = col_idx;
  d.slotted = Slotted{slab_ptr, slab_len, ovl_ptr, ovl_col};
  d.cursors = cursors;
  d.wavefront = wavefront;
  d.max_rounds = max_rounds;
  d.codec = Codec{granularity, width_bits};
  d.win = Windows{windows, windows + nb, windows + 2 * nb, splits, row_ptr,
                  n, threshold};
  d.bad = bad;
  d.bits = bits;
  d.bits_cap = bits_cap;
  d.lane_deg = lane_deg;
  d.block_count = block_count;
  d.barrier = barrier;
  d.wave_global = wave_global;
  d.visits = visits;
  d.trace = TraceRing{trace, trace_capacity, trace_cursor};
  void* args[] = {&d};
  err = cudaLaunchCooperativeKernel(
      kernel_for(granularity, packed != 0, traced, slotted), dim3(grid),
      dim3(kThreads), args, dyn, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
