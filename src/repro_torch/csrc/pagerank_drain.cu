// Asynchronous PageRank's whole drain in one cooperative launch, kernel
// B3-pr.
//
// Replaces the TPU kernel `make_fused_drain` / `fused_drain_pallas`
// (pallas_call at src/repro/kernels/drain_loop/kernel.py:121) for the
// PageRank program at every granularity 1 <= G <= 64.  The Pallas kernel
// evaluated any
// drain's jaxpr inside one launch; this is the PageRank program written out
// by hand.  It computes exactly what the port's plain fused drain
// (`fused_drain_ref` over `wavefront_step` with the PageRank body and
// on_empty) computes, while
//
//   rounds < min(max_rounds, limit) and max(residue) > eps:
//
//   1. pop      items[l] = buf[(head + l) % cap] for l < k = min(size, W),
//               each a chunk (head, width) (drain_common.cuh's codec);
//   2. dedup    a lane takes part only if it is the first lane of its chunk
//               head: atomicMin of ((max_rounds - round) << 32 | lane) on a
//               64-bit word per vertex (keys fall from round to round, so the
//               words need no reset);
//   3. scan     the inclusive int32 scan of the first lanes' chunk degrees;
//               truncated = first & scan > budget, processed = first & not
//               truncated; L = the scan at the last processed lane;
//   4. harvest  for each member row v of a processed chunk: keep its
//               pre-harvest res = residue[v] per member (lane, row), then
//               rank[v] += res, residue[v] = 0, and in_queue[v] = 0 unless v
//               is also a member row of a truncated chunk.  At G > 1 two
//               chunks may share a row, so the reads come first, a grid
//               barrier, then the writes: the residue taken by atomicExch
//               and added to rank by atomicAdd (a second taker adds +0.0,
//               which changes no bit), and the truncated rows stamped with
//               the round before the barrier;
//   5. expand   every unit u < L: owner by an upper-bound search of the scan
//               (kernel B1's search), rank, src the member row of the rank
//               (chunk_row_of), nbr from the chunk's row slice staged by
//               csr_stream.cuh (kernel B4's staging), and its contribution
//               (damping * res) / max(deg(src), 1) in f32, from src's
//               pre-harvest residue;
//   6. sum      residue[nbr] += contribution, each target's contributions in
//               unit order (below);
//   7. rescan   the n_check ids (cursor + j) % n: over = residue > eps and
//               not in_queue (the post-push values); in_queue = 1 where over;
//               at G > 1 the ids that are over coalesce into chunks over
//               G-aligned windows (drain_common.cuh's window_add /
//               window_emit, one more grid barrier);
//   8. push     [rescan chunks, window order] ++ [truncated items, wavefront
//               order] into the ring at tail + rank (ranks from prefix
//               sums), what exceeds the free slots dropped;
//   9. counters work += the widths of the processed chunks, splits += the
//               windows split, processed += k, rounds and the WorkCounter's
//               rounds += 1, cursor += n_check; and the next round's
//               condition, the grid-wide max of residue.
//
// A round with no item is the program's on_empty: steps 1-6 do nothing and
// the rescan and push run alone, which is what the plain step's selected
// branch computes.
//
// The ordered sum.  Float addition does not associate, so the persistent
// drain (the ordered_scatter_add kernel) and this drain agree bit for bit
// only if both add each target's contributions in unit order onto the
// harvested residue.  Here: each unit counts itself into its target with an
// atomicAdd, whose return value is the unit's arbitrary place in the
// target's segment; the unit that got place 0 reserves the segment's start
// in a scratch array from a cursor; every unit writes its id at start +
// place; every unit counts the ids below its own in its segment, which is
// its rank in unit order, and writes its contribution at start + rank; the
// place-0 unit's thread adds the segment left to right.  Five grid
// barriers, and no order depends on timing.  A segment is as long as its
// target's in-edges from the round's processed vertices (a few hundred at
// most for a hub); the rank scan reads the segment once per unit, and the
// threads of a warp that share a target read the same words.  (A first
// form sorted each segment by one thread with a heapsort in device memory:
// its dependent loads cost about 1.6 ms a round at rmat(21).)
//
// Structure, barriers and the push are drain_common.cuh's, as in
// bfs_drain.cu: every block pops and scans the whole wavefront itself;
// lanes, units and push positions are cut into one contiguous range per
// block.  Nine grid barriers a round with items, two without; at G > 1 one
// more for the harvest and one more for the rescan's windows.
//
// Modes.  The fused mode (B3-fused) drains lane 0 of the fused topology's
// one-lane MultiQueue: a popped word is unpacked to its task and a pushed
// task packed with job 0 (drain_common.cuh's lane_load / lane_store), which
// is what runtime/api.fused_lane_ops does around the same body.  The traced
// mode (B3-traced) writes one trace row a round from block 0 after the
// round's last barrier (drain_common.cuh's Tracer).  Each mode is a
// template argument, so the single, untraced instances are unchanged.
//
// What bounds the drain on an H100: bytes, about 12 bytes per unit (its
// col_idx word, the target's residue read and written) plus 24 per
// processed vertex and the rescan's 5 bytes per id, and the barriers.  The
// grid-wide max reads all n residues a round (8 MB at rmat(21)), which a
// later form could track incrementally.  Right first, fast later.

#include <cuda_runtime.h>

#include "csr_stream.cuh"
#include "drain_common.cuh"

namespace {

using namespace drain;

constexpr int kThreads = 512;
constexpr int kCheckCursor = kCursors;  // PageRank's rescan cursor
constexpr int kAhead = 8;  // loads issued ahead of the adds of a segment

struct Drain {
  int* buf;  // [cap] the task ring, updated in place
  int cap;
  float* rank;               // [n] updated in place
  float* residue;            // [n] updated in place
  unsigned char* in_queue;   // [n] presence bits (torch bool), in place
  int n;
  const int* row_ptr;  // [n + 1]
  const int* col_idx;  // [m]
  int m;
  int* cursors;  // [kCursors + 1]
  int wavefront;
  int budget;
  int n_check;
  float damping;
  float eps;
  int max_rounds;
  unsigned long long* first_lane;  // [n] dedup words, all ones at launch
  Codec codec;
  Windows win;                     // the rescan's chunk windows
  int* trunc_round;  // [n] the last round a truncated chunk held the row;
                     // zero at launch
  float* lane_res;   // [W G] pre-harvest residue of a lane's member rows
  int* unit_nbr;                   // [budget]
  float* unit_contrib;             // [budget]
  int* unit_place;                 // [budget] place in the target's segment
  int* seg;                        // [budget] unit ids grouped by target
  float* ordered;  // [budget] contributions grouped by target, unit order
  int* seg_count;   // [n] units a target gets this round; zero at launch
  int* seg_start;   // [n] start of a target's segment this round
  int* seg_cursor;  // [1]
  int* scan_keep;   // [n_check] a rescan id that is over, then what it
                    // pushes; -1 for none
  int* block_count;       // [gridDim.x] push count of each block
  float* block_max;       // [gridDim.x] residue max of each block's slice
  unsigned int* barrier;  // [2] arrivals, generation; zero at launch
  int* wave_global;  // [gridDim.x][2 W] when the wavefront does not fit in
                     // shared memory, else null
  long long* units;  // out: work units expanded through the stream
  TraceRing trace;   // the traced mode's ring
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

struct Unit {
  int owner;
  int src;
  int member;  // owner * G + src - head: the slot of src's residue
};

// kChunks = false is the G = 1 instance, whose codec is the compile-time
// identity: no multiplication or division by G, no window code.  kPacked is
// the fused mode, kTraced the traced mode.
template <bool kChunks, bool kPacked, bool kTraced>
__global__ void __launch_bounds__(kThreads, 1) pagerank_drain(Drain d) {
  extern __shared__ int dyn[];
  __shared__ int ring[csr_stream::kStages][kThreads];
  __shared__ int warp_sums[kThreads / 32];
  __shared__ float warp_max[kThreads / 32];
  const int W = d.wavefront;
  const int tid = threadIdx.x;
  const int G = gridDim.x;
  const Codec cc = kChunks ? d.codec : Codec{1, 0};
  int* items =
      d.wave_global ? d.wave_global + static_cast<size_t>(blockIdx.x) * 2 * W
                    : dyn;
  int* scan = items + W;

  int head = d.cursors[kHead];
  int tail = d.cursors[kTail];
  int dropped = d.cursors[kDropped];
  int rounds = d.cursors[kRounds];
  int processed = d.cursors[kProcessed];
  int work = d.cursors[kWork];
  const int splits = d.cursors[kSplits];
  int counter_rounds = d.cursors[kCounterRounds];
  const int limit = d.cursors[kLimit];
  int check_cursor = d.cursors[kCheckCursor];
  Tracer<kTraced> tracer;
  tracer.begin(d.trace);
  // every block has read the cursors before block 0 may write them back
  grid_barrier(d.barrier);

  int r0, r1;  // this block's slice of the vertices, for the max
  block_range(d.n, blockIdx.x, G, r0, r1);
  // the grid-wide max of residue: each block's partial, a barrier, then
  // every block reduces all partials itself
  auto publish_max = [&]() {
    float v = neg_inf();
    for (int i = r0 + tid; i < r1; i += kThreads) {
      v = fmaxf(v, __ldcg(d.residue + i));
    }
    v = block_max<kThreads>(v, warp_max);
    if (tid == 0) d.block_max[blockIdx.x] = v;
  };
  auto read_max = [&]() {
    float v = neg_inf();
    for (int b = tid; b < G; b += kThreads) {
      v = fmaxf(v, __ldcg(d.block_max + b));
    }
    return block_max<kThreads>(v, warp_max);
  };
  publish_max();
  grid_barrier(d.barrier);
  float max_res = read_max();
  // every block has read the partials before any block writes the next
  grid_barrier(d.barrier);

  long long units = 0;
  const int per_thread = (W + kThreads - 1) / kThreads;
  const int l0 = min(tid * per_thread, W);
  const int l1 = min(l0 + per_thread, W);
  while (rounds < d.max_rounds && rounds < limit && max_res > d.eps) {
    const int size = wrap_sub(tail, head);
    const int k = size < W ? size : W;
    const unsigned long long stamp =
        static_cast<unsigned long long>(
            static_cast<unsigned>(wrap_sub(d.max_rounds, rounds)))
        << 32;
    const unsigned r = static_cast<unsigned>(rounds) + 1u;
    int round_work = 0;
    if (k > 0) {
      // 1-2. pop (this block's own copy) and claim the dedup words of this
      // block's lanes
      for (int l = l0; l < l1; ++l) {
        items[l] = l < k ? lane_load<kPacked>(__ldcg(
                               d.buf + ring_slot(wrap_add(head, l), d.cap)))
                         : kEmpty;
      }
      __syncthreads();
      int la, lb;
      block_range(k, blockIdx.x, G, la, lb);
      for (int l = la + tid; l < lb; l += kThreads) {
        const int v = chunk_head(items[l], cc);
        if (items[l] != kEmpty && v >= 0 && v < d.n) {
          atomicMin(d.first_lane + v, stamp | static_cast<unsigned>(l));
        }
      }
      grid_barrier(d.barrier);

      // 3. first lanes, chunk degrees, scan; a lane that takes no part is
      // kEmpty
      for (int l = l0; l < l1; ++l) {
        int deg = 0;
        const int item = items[l];
        const int v = chunk_head(item, cc);
        if (l < k && item != kEmpty && v >= 0 && v < d.n &&
            __ldcg(d.first_lane + v) == (stamp | static_cast<unsigned>(l))) {
          deg = chunk_degree(d.row_ptr, v, chunk_width(item, cc), d.n);
        } else {
          items[l] = kEmpty;
        }
        scan[l] = deg;
      }
      inclusive_scan_lanes<kThreads>(scan, l0, l1, warp_sums);
      int work_local = 0;
      for (int l = l0; l < l1; ++l) {
        if (items[l] != kEmpty && scan[l] <= d.budget) {
          work_local += chunk_width(items[l], cc);
        }
      }
      round_work = block_sum<kThreads>(work_local, warp_sums);
      const int cut = upper_bound(scan, W, d.budget);
      const int L = cut > 0 ? scan[cut - 1] : 0;
      units += L;

      // 4. harvest this block's lanes: the pre-harvest residues and the
      // truncated chunks' rows, (at G > 1 a barrier,) then the writes.  At
      // G = 1 a vertex has one first lane, so no other lane touches its row
      // between the reads and the writes.
      for (int l = la + tid; l < lb; l += kThreads) {
        const int item = items[l];
        if (item == kEmpty) continue;
        const int v = chunk_head(item, cc);
        const int width = chunk_width(item, cc);
        for (int j = 0; j < width && v + j < d.n; ++j) {
          if (scan[l] <= d.budget) {
            d.lane_res[l * cc.G + j] = __ldcg(d.residue + v + j);
          } else {
            d.trunc_round[v + j] = static_cast<int>(r);
          }
        }
      }
      if (cc.G > 1) grid_barrier(d.barrier);
      for (int l = la + tid; l < lb; l += kThreads) {
        const int item = items[l];
        if (item == kEmpty || scan[l] > d.budget) continue;
        const int v = chunk_head(item, cc);
        const int width = chunk_width(item, cc);
        for (int j = 0; j < width && v + j < d.n; ++j) {
          const int row = v + j;
          atomicAdd(d.rank + row, atomicExch(d.residue + row, 0.0f));
          if (__ldcg(d.trunc_round + row) != static_cast<int>(r)) {
            d.in_queue[row] = 0;
          }
        }
      }
      grid_barrier(d.barrier);

      // 5. expand this block's units through the row-slice stream
      int ua, ub;
      block_range(L, blockIdx.x, G, ua, ub);
      if (blockIdx.x == 0 && tid == 0) *d.seg_cursor = 0;
      const int tiles = ub > ua ? (ub - ua + kThreads - 1) / kThreads : 0;
      auto stage = [&](int s, int slot) {
        Unit unit{0, 0, 0};
        const int u = ua + s * kThreads + tid;
        if (u < ub) {
          unit.owner = upper_bound(scan, W, u);
          const int rank = u - (unit.owner > 0 ? scan[unit.owner - 1] : 0);
          const int item = items[unit.owner];
          const int chead = chunk_head(item, cc);
          unit.src = chunk_row_of(d.row_ptr, chead, rank,
                                  chunk_width(item, cc), d.n);
          unit.member = unit.owner * cc.G + (unit.src - chead);
          const long long start =
              csr_stream::slice_start(__ldg(d.row_ptr + chead), d.m);
          csr_stream::stage_element(&ring[slot][tid], d.col_idx, d.m,
                                    start + clamp_to(rank, 0, d.budget - 1));
        }
        csr_stream::commit_stage();
        return unit;
      };
      Unit cur{0, 0, 0};
      if (tiles > 0) cur = stage(0, 0);
      for (int s = 0; s < tiles; ++s) {
        const bool more = s + 1 < tiles;
        Unit next{0, 0, 0};
        if (more) next = stage(s + 1, (s + 1) & 1);
        csr_stream::wait_stage(more);
        const int u = ua + s * kThreads + tid;
        if (u < ub) {
          const int nbr = ring[s & 1][tid];
          const int deg = wrap_sub(__ldg(d.row_ptr + cur.src + 1),
                                   __ldg(d.row_ptr + cur.src));
          const float contrib =
              __fdiv_rn(__fmul_rn(d.damping, __ldcg(d.lane_res + cur.member)),
                        static_cast<float>(deg > 1 ? deg : 1));
          d.unit_nbr[u] = nbr;
          d.unit_contrib[u] = contrib;
          d.unit_place[u] = atomicAdd(d.seg_count + nbr, 1);
        }
        __syncthreads();  // slot s & 1 is refilled by stage s + 2
        cur = next;
      }
      grid_barrier(d.barrier);

      // 6. the ordered sum: reserve, place, rank, then add per target
      for (int u = ua + tid; u < ub; u += kThreads) {
        if (d.unit_place[u] == 0) {
          const int t = d.unit_nbr[u];
          d.seg_start[t] = atomicAdd(d.seg_cursor, __ldcg(d.seg_count + t));
        }
      }
      grid_barrier(d.barrier);
      for (int u = ua + tid; u < ub; u += kThreads) {
        d.seg[__ldcg(d.seg_start + d.unit_nbr[u]) + d.unit_place[u]] = u;
      }
      grid_barrier(d.barrier);
      // each unit's rank in its segment is the number of its segment's
      // units with a lower id; its contribution goes to that place
      for (int u = ua + tid; u < ub; u += kThreads) {
        const int t = d.unit_nbr[u];
        const int start = __ldcg(d.seg_start + t);
        const int len = __ldcg(d.seg_count + t);
        int r = 0;
        for (int i = 0; i < len; ++i) r += __ldcg(d.seg + start + i) < u;
        d.ordered[start + r] = d.unit_contrib[u];
      }
      grid_barrier(d.barrier);
      for (int u = ua + tid; u < ub; u += kThreads) {
        if (d.unit_place[u] == 0) {
          const int t = d.unit_nbr[u];
          const int start = __ldcg(d.seg_start + t);
          const int len = __ldcg(d.seg_count + t);
          float acc = __ldcg(d.residue + t);
          for (int i = 0; i < len; i += kAhead) {
            float v[kAhead];
#pragma unroll
            for (int j = 0; j < kAhead; ++j) {
              v[j] = i + j < len ? __ldcg(d.ordered + start + i + j) : 0.0f;
            }
#pragma unroll
            for (int j = 0; j < kAhead; ++j) {
              if (i + j < len) acc = __fadd_rn(acc, v[j]);
            }
          }
          d.residue[t] = acc;
          d.seg_count[t] = 0;
        }
      }
      grid_barrier(d.barrier);
    }

    // 7. rescan (post-push residue and presence bits), this block's push
    // count and its share of the residue max
    const int P = d.n_check + k;
    int lo, hi;
    block_range(P, blockIdx.x, G, lo, hi);
    int kept_local = 0;
    for (int p = lo + tid; p < hi; p += kThreads) {
      if (p < d.n_check) {
        const int id = py_mod(wrap_add(check_cursor, p), d.n);
        const bool over =
            __ldcg(d.residue + id) > d.eps && __ldcg(d.in_queue + id) == 0;
        if (over) {
          d.in_queue[id] = 1;
          if (cc.G > 1) {
            window_add(d.win, id, cc, r);
          } else {
            ++kept_local;
          }
        }
        d.scan_keep[p] = over ? id : -1;
      } else {
        const int l = p - d.n_check;
        if (items[l] != kEmpty && scan[l] > d.budget) ++kept_local;
      }
    }
    if (cc.G > 1) {
      grid_barrier(d.barrier);
      // the window reads: what each rescan id that is over pushes
      for (int p = lo + tid; p < min(hi, d.n_check); p += kThreads) {
        const int id = d.scan_keep[p];
        if (id < 0) continue;
        const int value = window_emit(d.win, id, cc, true);
        d.scan_keep[p] = value;
        kept_local += value >= 0;
      }
    }
    const int kept = block_sum<kThreads>(kept_local, warp_sums);
    if (tid == 0) d.block_count[blockIdx.x] = kept;
    publish_max();
    grid_barrier(d.barrier);

    // 8. the ring write at tail + rank, and the next condition's max
    const int head_after = wrap_add(head, k);
    const int free_slots = d.cap - wrap_sub(tail, head_after);
    const int count = ring_push<kThreads, kPacked>(
        d.buf, d.cap, tail, free_slots, d.block_count, lo, hi, warp_sums,
        [&](int p, int& value) {
          if (p < d.n_check) {
            value = d.scan_keep[p];
            return value >= 0;
          }
          const int l = p - d.n_check;
          value = items[l];
          return items[l] != kEmpty && scan[l] > d.budget;
        });
    max_res = read_max();
    grid_barrier(d.barrier);

    // 9. cursors and counters, the same in every block
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
    check_cursor = wrap_add(check_cursor, d.n_check);
  }

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
    d.cursors[kCheckCursor] = check_cursor;
    *d.units = units;
  }
  tracer.end(d.trace);
}

// The instance of a granularity and mode.
template <bool kChunks, bool kPacked>
const void* instance(bool traced) {
  return traced ? reinterpret_cast<const void*>(
                      pagerank_drain<kChunks, kPacked, true>)
                : reinterpret_cast<const void*>(
                      pagerank_drain<kChunks, kPacked, false>);
}

const void* kernel_for(int granularity, bool packed, bool traced) {
  if (granularity > 1) {
    return packed ? instance<true, true>(traced)
                  : instance<true, false>(traced);
  }
  return packed ? instance<false, true>(traced)
                : instance<false, false>(traced);
}

// The launch plan for a wavefront of W at granularity G in a mode: dynamic
// shared memory (0 when the wavefront goes to global scratch) and the
// co-resident grid of that instance.
cudaError_t plan(int W, int granularity, bool packed, bool traced, size_t* dyn,
                 int* grid) {
  const void* kernel = kernel_for(granularity, packed, traced);
  DeviceInfo info;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const size_t wave = 2 * static_cast<size_t>(W) * sizeof(int);
  *dyn = wave + attr.sharedSizeBytes <= static_cast<size_t>(info.smem_optin)
             ? wave
             : 0;
  return cooperative_grid(kernel, kThreads, *dyn, grid);
}

}  // namespace

// The grid the launch takes for a wavefront of W at granularity G in a mode
// (packed: the fused mode; traced: the traced mode), and whether the
// wavefront lives in shared memory (1) or in global scratch of grid * 2 W
// ints (0).  Returns the cudaError_t (0 on success).
extern "C" int pagerank_drain_grid(int wavefront, int granularity, int packed,
                                   int traced, int* grid,
                                   int* wave_in_shared) {
  size_t dyn = 0;
  const cudaError_t err =
      plan(wavefront, granularity, packed != 0, traced != 0, &dyn, grid);
  if (err != cudaSuccess) return err;
  *wave_in_shared = dyn > 0;
  return cudaSuccess;
}

// One cooperative launch of the whole drain on `stream`.  `grid` and
// `wave_global` come from pagerank_drain_grid; the scratch is sized by the
// caller: first_lane n words of all ones; lane_res W G floats; unit_nbr,
// unit_contrib, unit_place, seg and ordered budget words each; seg_count n
// zeroed ints; seg_start n ints; seg_cursor one int; scan_keep n_check
// ints; trunc_round n zeroed ints; windows 3 (n / G +
// 2) zeroed words, then one zeroed split count; block_count grid ints;
// block_max grid floats; barrier 2 zeroed words; units one word, which gets
// the number of work units the drain expanded.  `threshold` is the rescan's
// split threshold (INT_MAX for none).  `packed` selects the fused mode
// (buf is lane 0 of a one-lane MultiQueue); a non-null `trace` the traced
// mode, with its [trace_capacity][13] rows and one-int cursor, both updated
// in place.  Returns the cudaError_t of the launch (0 on success).
extern "C" int pagerank_drain_launch(
    int* buf, int cap, float* rank, float* residue, unsigned char* in_queue,
    int n, const int* row_ptr, const int* col_idx, int m, int* cursors,
    int wavefront, int budget, int n_check, float damping, float eps,
    int max_rounds, int granularity, int width_bits, int threshold,
    unsigned long long* first_lane, float* lane_res, int* unit_nbr,
    float* unit_contrib, int* unit_place, int* seg, float* ordered,
    int* seg_count, int* seg_start, int* seg_cursor, int* scan_keep,
    int* trunc_round, unsigned long long* windows, unsigned int* splits,
    int* block_count, float* block_max, unsigned int* barrier,
    int* wave_global, long long* units, int packed, int* trace,
    int trace_capacity, int* trace_cursor, int grid, cudaStream_t stream) {
  size_t dyn = 0;
  int most = 0;
  const bool traced = trace != nullptr;
  if (granularity < 1 || granularity > 64) return cudaErrorInvalidValue;
  if (traced && (trace_capacity < 1 || trace_cursor == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err =
      plan(wavefront, granularity, packed != 0, traced, &dyn, &most);
  if (err != cudaSuccess) return err;
  if (grid < 1 || grid > most) return cudaErrorInvalidValue;
  if ((dyn == 0) != (wave_global != nullptr)) return cudaErrorInvalidValue;
  const size_t nb = static_cast<size_t>(n / granularity + 2);
  Drain d{};
  d.buf = buf;
  d.cap = cap;
  d.rank = rank;
  d.residue = residue;
  d.in_queue = in_queue;
  d.n = n;
  d.row_ptr = row_ptr;
  d.col_idx = col_idx;
  d.m = m;
  d.cursors = cursors;
  d.wavefront = wavefront;
  d.budget = budget;
  d.n_check = n_check;
  d.damping = damping;
  d.eps = eps;
  d.max_rounds = max_rounds;
  d.first_lane = first_lane;
  d.codec = Codec{granularity, width_bits};
  d.win = Windows{windows, windows + nb, windows + 2 * nb, splits, row_ptr,
                  n, threshold};
  d.trunc_round = trunc_round;
  d.lane_res = lane_res;
  d.unit_nbr = unit_nbr;
  d.unit_contrib = unit_contrib;
  d.unit_place = unit_place;
  d.seg = seg;
  d.ordered = ordered;
  d.seg_count = seg_count;
  d.seg_start = seg_start;
  d.seg_cursor = seg_cursor;
  d.scan_keep = scan_keep;
  d.block_count = block_count;
  d.block_max = block_max;
  d.barrier = barrier;
  d.wave_global = wave_global;
  d.units = units;
  d.trace = TraceRing{trace, trace_capacity, trace_cursor};
  void* args[] = {&d};
  err = cudaLaunchCooperativeKernel(
      kernel_for(granularity, packed != 0, traced), dim3(grid),
      dim3(kThreads), args, dyn, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
