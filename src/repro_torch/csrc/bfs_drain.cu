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
//               src the member row of the rank (chunk_row_of), and nbr from
//               the chunk's row slice staged by the stream of csr_stream.cuh
//               (kernel B4's staging: a chunk's rows are contiguous in CSR,
//               so one slice a chunk);
//   5. relax    cand = dist[src] + 1 and before = dist[nbr], both read from
//               the round-start dist; improved = live & cand < before;
//   6. dedup    of the improved units with one nbr only the lowest stays:
//               atomicMin of ((max_rounds - round) << 32 | unit) on a 64-bit
//               word per vertex; and the new dist[nbr], the least cand, by
//               atomicMin of ((max_rounds - round) << 32 | cand ^ 2^31) on
//               a second word (the flipped sign bit orders int32 as
//               unsigned).  Keys fall from round to round, so neither array needs
//               a reset, and dist itself is not written until every read of
//               step 5 is done: the unit that stays writes it;
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
// lowest lane.  Its total is bounded by W times the largest chunk degree
// and not by a budget, so per_item keeps no per-unit scratch: the phases
// after step 5 recompute a unit's nbr from the scan (the search and one
// col_idx word) and read its dedup word again.  Merge path keeps each
// unit's nbr (or -1) in `unit_nbr`, budget words.
//
// Structure.  The grid is as many blocks as fit on the card at once
// (occupancy x SMs) and is launched with cudaLaunchCooperativeKernel, which
// refuses a grid that could not be co-resident instead of hanging.  Every
// block pops and scans the whole wavefront itself, into shared memory, so
// the wavefront costs no grid barrier, and every block keeps the cursors in
// registers and updates them identically, so the loop condition is the same
// in every block.  The round's push positions (the units up to L, then the
// wavefront's items) are cut into one contiguous range per block; each block
// expands, dedups and pushes its own range, in tiles of one unit per thread.
// Grid barriers a round: after the reads and atomics of steps 5-6, after
// the dist writes (and the window atomics), at G > 1 after the window
// reads, and after the per-block push counts and the ring write: three at
// G = 1, four at G > 1.  Values that other blocks write inside the launch
// (the ring, the dedup words, the windows, the push counts) are read with
// ld.global.cg, past the SM's incoherent L1.
//
// Modes.  The fused mode (B3-fused) drains lane 0 of the fused topology's
// one-lane MultiQueue: a popped word is unpacked to its task and a pushed
// task packed with job 0 (drain_common.cuh's lane_load / lane_store), which
// is what runtime/api.fused_lane_ops does around the same body.  The traced
// mode (B3-traced) writes one trace row a round from block 0 after the
// round's last barrier (drain_common.cuh's Tracer).  Each mode is a
// template argument, so the single, untraced instances are unchanged.
//
// What bounds the drain on an H100: bytes, about 8 bytes per expanded edge
// (its col_idx word and dist[nbr]) plus the ring traffic, and the grid
// barriers.  The first form keeps it simple: the kernel is right first, and
// TMA, warp specialisation and fewer barriers are later work.

#include <cuda_runtime.h>

#include "csr_stream.cuh"
#include "drain_common.cuh"

namespace {

using namespace drain;

constexpr int kThreads = 512;

struct Drain {
  int* buf;  // [cap] the task ring, updated in place
  int cap;
  int* dist;  // [n] hop distances, updated in place
  int n;
  const int* row_ptr;  // [n + 1]
  const int* col_idx;  // [m]
  int m;
  int* cursors;  // [kCursors]
  int wavefront;
  int budget;  // INT_MAX for per_item: no truncation, L = total
  int stored;  // units whose nbr is kept in unit_nbr: budget, or 0
  int max_rounds;
  Codec codec;
  Windows win;
  int* unit_nbr;  // [stored] nbr of an improved unit, then what it pushes;
                  // -1 for none
  unsigned long long* first_unit;  // [n] dedup words, all ones at launch
  unsigned long long* best;        // [n] least-cand words, all ones
  int* block_count;                // [gridDim.x] push count of each block
  unsigned int* barrier;           // [2] arrivals, generation; zero at launch
  int* wave_global;  // [gridDim.x][2 W] when the wavefront does not fit in
                     // shared memory, else null
  long long* units;  // out: work units expanded through the stream
  TraceRing trace;   // the traced mode's ring
};

struct Unit {
  int owner;
  int src;
};

// kChunks = false is the G = 1 instance, whose codec is the compile-time
// identity: no multiplication or division by G, no window code.  kPacked is
// the fused mode, kTraced the traced mode.
template <bool kChunks, bool kPacked, bool kTraced>
__global__ void __launch_bounds__(kThreads, 1) bfs_drain(Drain d) {
  extern __shared__ int dyn[];
  __shared__ int ring[csr_stream::kStages][kThreads];
  __shared__ int warp_sums[kThreads / 32];
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
  Tracer<kTraced> tracer;
  tracer.begin(d.trace);
  // every block has read the cursors before block 0 may write them back
  grid_barrier(d.barrier);

  long long units = 0;
  const int per_thread = (W + kThreads - 1) / kThreads;
  const int l0 = min(tid * per_thread, W);
  const int l1 = min(l0 + per_thread, W);
  while (rounds < d.max_rounds && rounds < limit && wrap_sub(tail, head) > 0) {
    const int size = wrap_sub(tail, head);
    const int k = size < W ? size : W;

    // 1-3. pop, chunk degrees, inclusive scan, truncation: this block's own
    // copy
    for (int l = l0; l < l1; ++l) {
      int item = kEmpty;
      int deg = 0;
      if (l < k) {
        item = lane_load<kPacked>(
            __ldcg(d.buf + ring_slot(wrap_add(head, l), d.cap)));
        deg = chunk_degree(d.row_ptr, chunk_head(item, cc),
                           chunk_width(item, cc), d.n);
      }
      items[l] = item;
      scan[l] = deg;
    }
    inclusive_scan_lanes<kThreads>(scan, l0, l1, warp_sums);
    int work_local = 0;
    for (int l = l0; l < l1; ++l) {
      if (l < k && scan[l] <= d.budget) work_local += chunk_width(items[l], cc);
    }
    const int round_work = block_sum<kThreads>(work_local, warp_sums);
    const int total = scan[W - 1];
    const int L = total < 0 ? 0 : (total < d.budget ? total : d.budget);
    units += L;

    // this block's range of push positions: units [0, L), then items
    const int P = wrap_add(L, k);
    int lo, hi;
    block_range(P, blockIdx.x, G, lo, hi);
    const int a_hi = min(hi, L);
    const int tiles_a = a_hi > lo ? (a_hi - lo + kThreads - 1) / kThreads : 0;
    const unsigned long long stamp =
        static_cast<unsigned long long>(
            static_cast<unsigned>(wrap_sub(d.max_rounds, rounds)))
        << 32;
    const unsigned r = static_cast<unsigned>(rounds) + 1u;

    // a unit's owner, rank, chunk head and width
    auto locate = [&](int u, int& owner, int& rank, int& chead, int& width) {
      owner = upper_bound(scan, W, u);
      rank = u - (owner > 0 ? scan[owner - 1] : 0);
      const int item = owner < k ? items[owner] : 0;
      chead = chunk_head(item, cc);
      width = chunk_width(item, cc);
    };
    // the kept nbr of unit u (or -1), for a unit past the stored ones: its
    // nbr recomputed, then its dedup word read back
    auto kept_target = [&](int u) {
      int owner, rank, chead, width;
      locate(u, owner, rank, chead, width);
      const long long e =
          csr_stream::slice_start(__ldg(d.row_ptr + chead), d.m) + rank;
      const int nbr = e < d.m ? __ldg(d.col_idx + e) : 0;
      return __ldcg(d.first_unit + nbr) == (stamp | static_cast<unsigned>(u))
                 ? nbr
                 : -1;
    };

    // 4-6. expand through the row-slice stream; read, do not write, dist;
    // claim the dedup and least-cand words
    auto stage = [&](int s, int slot) {
      Unit unit{0, 0};
      const int u = lo + s * kThreads + tid;
      if (u < a_hi) {
        int rank, chead, width;
        locate(u, unit.owner, rank, chead, width);
        unit.src = chunk_row_of(d.row_ptr, chead, rank, width, d.n);
        const long long start =
            csr_stream::slice_start(__ldg(d.row_ptr + chead), d.m);
        csr_stream::stage_element(&ring[slot][tid], d.col_idx, d.m,
                                  start + clamp_to(rank, 0, d.budget - 1));
      }
      csr_stream::commit_stage();
      return unit;
    };
    Unit cur{0, 0};
    if (tiles_a > 0) cur = stage(0, 0);
    for (int s = 0; s < tiles_a; ++s) {
      const bool more = s + 1 < tiles_a;
      Unit next{0, 0};
      if (more) next = stage(s + 1, (s + 1) & 1);
      csr_stream::wait_stage(more);
      const int u = lo + s * kThreads + tid;
      if (u < a_hi) {
        const int nbr = ring[s & 1][tid];
        const bool live = !(cur.owner < k && scan[cur.owner] > d.budget);
        const int cand = wrap_add(__ldcg(d.dist + cur.src), 1);
        const int before = __ldcg(d.dist + nbr);
        const bool improved = live && cand < before;
        if (improved) {
          atomicMin(d.first_unit + nbr, stamp | static_cast<unsigned>(u));
          atomicMin(d.best + nbr, stamp | (static_cast<unsigned>(cand) ^
                                           0x80000000u));
        }
        if (u < d.stored) d.unit_nbr[u] = improved ? nbr : -1;
      }
      __syncthreads();  // slot s & 1 is refilled by stage s + 2
      cur = next;
    }
    grid_barrier(d.barrier);

    // 6-7. the unit that stays writes dist[nbr] and marks its window; at
    // G = 1 it is what the unit pushes, and the block counts it
    int kept_local = 0;
    for (int u = lo + tid; u < a_hi; u += kThreads) {
      int nbr;
      if (u < d.stored) {
        nbr = d.unit_nbr[u];
        if (nbr < 0) continue;
        if (__ldcg(d.first_unit + nbr) != (stamp | static_cast<unsigned>(u))) {
          d.unit_nbr[u] = -1;
          continue;
        }
      } else {
        nbr = kept_target(u);
        if (nbr < 0) continue;
      }
      d.dist[nbr] = static_cast<int>(
          static_cast<unsigned>(__ldcg(d.best + nbr) & 0xffffffffull) ^
          0x80000000u);
      if (cc.G > 1) {
        window_add(d.win, nbr, cc, r);
      } else {
        ++kept_local;
      }
    }
    if (cc.G > 1) {
      grid_barrier(d.barrier);
      // 7. the window reads: what each kept unit pushes
      for (int u = lo + tid; u < a_hi; u += kThreads) {
        const int nbr = u < d.stored ? d.unit_nbr[u] : kept_target(u);
        if (nbr < 0) continue;
        const int value = window_emit(d.win, nbr, cc, true);
        if (u < d.stored) d.unit_nbr[u] = value;
        kept_local += value >= 0;
      }
    }
    for (int p = max(lo, L) + tid; p < hi; p += kThreads) {
      if (scan[p - L] > d.budget) ++kept_local;
    }
    const int kept = block_sum<kThreads>(kept_local, warp_sums);
    if (tid == 0) d.block_count[blockIdx.x] = kept;
    grid_barrier(d.barrier);

    // 8. the ring write at tail + rank
    const int head_after = wrap_add(head, k);
    const int free_slots = d.cap - wrap_sub(tail, head_after);
    const int count = ring_push<kThreads, kPacked>(
        d.buf, d.cap, tail, free_slots, d.block_count, lo, hi, warp_sums,
        [&](int p, int& value) {
          if (p < L) {
            if (p < d.stored) {
              value = d.unit_nbr[p];
            } else {
              value = kept_target(p);
              if (value >= 0 && cc.G > 1) {
                value = window_emit(d.win, value, cc, false);
              }
            }
            return value >= 0;
          }
          value = items[p - L];
          return scan[p - L] > d.budget;
        });
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
template <bool kChunks, bool kPacked>
const void* instance(bool traced) {
  return traced
             ? reinterpret_cast<const void*>(bfs_drain<kChunks, kPacked, true>)
             : reinterpret_cast<const void*>(
                   bfs_drain<kChunks, kPacked, false>);
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
extern "C" int bfs_drain_grid(int wavefront, int granularity, int packed,
                              int traced, int* grid, int* wave_in_shared) {
  size_t dyn = 0;
  const cudaError_t err =
      plan(wavefront, granularity, packed != 0, traced != 0, &dyn, grid);
  if (err != cudaSuccess) return err;
  *wave_in_shared = dyn > 0;
  return cudaSuccess;
}

// One cooperative launch of the whole drain on `stream`.  `grid` and
// `wave_global` come from bfs_drain_grid; the scratch is sized by the caller
// (unit_nbr: `stored` ints, `stored` being budget for merge path and 0 for
// per_item, whose budget is INT_MAX; first_unit and best: n words of all
// ones each; windows: 3 (n / G + 2) zeroed words, then one zeroed split
// count; block_count: grid ints; barrier: 2 zeroed words; units: one word,
// which gets the number of work units the drain expanded).  `threshold` is
// the split threshold (INT_MAX for none).  `packed` selects the fused mode
// (buf is lane 0 of a one-lane MultiQueue); a non-null `trace` the traced
// mode, with its [trace_capacity][13] rows and one-int cursor, both updated
// in place.  Returns the cudaError_t of the launch (0 on success).
extern "C" int bfs_drain_launch(
    int* buf, int cap, int* dist, int n, const int* row_ptr,
    const int* col_idx, int m, int* cursors, int wavefront, int budget,
    int stored, int max_rounds, int granularity, int width_bits,
    int threshold, int* unit_nbr, unsigned long long* first_unit,
    unsigned long long* best, unsigned long long* windows,
    unsigned int* splits, int* block_count, unsigned int* barrier,
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
  d.dist = dist;
  d.n = n;
  d.row_ptr = row_ptr;
  d.col_idx = col_idx;
  d.m = m;
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
  d.block_count = block_count;
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
