// Asynchronous PageRank's whole drain in one cooperative launch, kernel
// B3-pr.
//
// Replaces the TPU kernel `make_fused_drain` / `fused_drain_pallas`
// (pallas_call at src/repro/kernels/drain_loop/kernel.py:121) for the
// PageRank program at granularity 1.  The Pallas kernel evaluated any
// drain's jaxpr inside one launch; this is the PageRank program written out
// by hand.  It computes exactly what the port's plain fused drain
// (`fused_drain_ref` over `wavefront_step` with the PageRank body and
// on_empty) computes, while
//
//   rounds < min(max_rounds, limit) and max(residue) > eps:
//
//   1. pop      items[l] = buf[(head + l) % cap] for l < k = min(size, W);
//   2. dedup    a lane takes part only if it is the first lane of its vertex:
//               atomicMin of ((max_rounds - round) << 32 | lane) on a 64-bit
//               word per vertex (keys fall from round to round, so the words
//               need no reset);
//   3. scan     the inclusive int32 scan of the first lanes' degrees;
//               truncated = first & scan > budget, processed = first & not
//               truncated; L = the scan at the last processed lane;
//   4. harvest  for each processed vertex v: keep res = residue[v],
//               rank[v] += res, residue[v] = 0, in_queue[v] = 0;
//   5. expand   every unit u < L: owner by an upper-bound search of the scan
//               (kernel B1's search), rank, nbr from the row slice staged by
//               csr_stream.cuh (kernel B4's staging), and its contribution
//               (damping * res) / max(deg, 1) in f32, from the owner's
//               pre-harvest residue;
//   6. sum      residue[nbr] += contribution, each target's contributions in
//               unit order (below);
//   7. rescan   the n_check ids (cursor + j) % n: over = residue > eps and
//               not in_queue (the post-push values); in_queue = 1 where over;
//   8. push     [rescan ids that are over, window order] ++ [truncated items,
//               wavefront order] into the ring at tail + rank (ranks from
//               prefix sums), what exceeds the free slots dropped;
//   9. counters work += processed lanes, processed += k, rounds and the
//               WorkCounter's rounds += 1, cursor += n_check; and the next
//               round's condition, the grid-wide max of residue.
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
// block.  Nine grid barriers a round with items, two without.
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
  float* lane_res;                 // [W] pre-harvest residue of a lane
  int* unit_nbr;                   // [budget]
  float* unit_contrib;             // [budget]
  int* unit_place;                 // [budget] place in the target's segment
  int* seg;                        // [budget] unit ids grouped by target
  float* ordered;  // [budget] contributions grouped by target, unit order
  int* seg_count;   // [n] units a target gets this round; zero at launch
  int* seg_start;   // [n] start of a target's segment this round
  int* seg_cursor;  // [1]
  int* scan_keep;   // [n_check] a rescan id that is over, else -1
  int* block_count;       // [gridDim.x] push count of each block
  float* block_max;       // [gridDim.x] residue max of each block's slice
  unsigned int* barrier;  // [2] arrivals, generation; zero at launch
  int* wave_global;  // [gridDim.x][2 W] when the wavefront does not fit in
                     // shared memory, else null
  long long* units;  // out: work units expanded through the stream
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

struct Unit {
  int owner;
  int src;
};

__global__ void __launch_bounds__(kThreads, 1) pagerank_drain(Drain d) {
  extern __shared__ int dyn[];
  __shared__ int ring[csr_stream::kStages][kThreads];
  __shared__ int warp_sums[kThreads / 32];
  __shared__ float warp_max[kThreads / 32];
  const int W = d.wavefront;
  const int tid = threadIdx.x;
  const int G = gridDim.x;
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
    int n_proc = 0;
    if (k > 0) {
      // 1-2. pop (this block's own copy) and claim the dedup words of this
      // block's lanes
      for (int l = l0; l < l1; ++l) {
        items[l] = l < k ? __ldcg(d.buf + ring_slot(wrap_add(head, l), d.cap))
                         : kEmpty;
      }
      __syncthreads();
      int la, lb;
      block_range(k, blockIdx.x, G, la, lb);
      for (int l = la + tid; l < lb; l += kThreads) {
        const int v = items[l];
        if (v >= 0 && v < d.n) {
          atomicMin(d.first_lane + v, stamp | static_cast<unsigned>(l));
        }
      }
      grid_barrier(d.barrier);

      // 3. first lanes, degrees, scan; a lane that takes no part is kEmpty
      for (int l = l0; l < l1; ++l) {
        int deg = 0;
        const int v = items[l];
        if (l < k && v >= 0 && v < d.n &&
            __ldcg(d.first_lane + v) == (stamp | static_cast<unsigned>(l))) {
          deg = wrap_sub(__ldg(d.row_ptr + v + 1), __ldg(d.row_ptr + v));
        } else {
          items[l] = kEmpty;
        }
        scan[l] = deg;
      }
      inclusive_scan_lanes<kThreads>(scan, l0, l1, warp_sums);
      int proc_local = 0;
      for (int l = l0; l < l1; ++l) {
        if (items[l] != kEmpty && scan[l] <= d.budget) ++proc_local;
      }
      n_proc = block_sum<kThreads>(proc_local, warp_sums);
      const int cut = upper_bound(scan, W, d.budget);
      const int L = cut > 0 ? scan[cut - 1] : 0;
      units += L;

      // 4. harvest this block's lanes
      for (int l = la + tid; l < lb; l += kThreads) {
        const int v = items[l];
        if (v != kEmpty && scan[l] <= d.budget) {
          const float res = __ldcg(d.residue + v);
          d.lane_res[l] = res;
          d.rank[v] = __fadd_rn(__ldcg(d.rank + v), res);
          d.residue[v] = 0.0f;
          d.in_queue[v] = 0;
        }
      }
      grid_barrier(d.barrier);

      // 5. expand this block's units through the row-slice stream
      int ua, ub;
      block_range(L, blockIdx.x, G, ua, ub);
      if (blockIdx.x == 0 && tid == 0) *d.seg_cursor = 0;
      const int tiles = ub > ua ? (ub - ua + kThreads - 1) / kThreads : 0;
      auto stage = [&](int s, int slot) {
        Unit unit{0, 0};
        const int u = ua + s * kThreads + tid;
        if (u < ub) {
          unit.owner = upper_bound(scan, W, u);
          const int rank = u - (unit.owner > 0 ? scan[unit.owner - 1] : 0);
          unit.src = items[unit.owner];
          const long long start =
              csr_stream::slice_start(__ldg(d.row_ptr + unit.src), d.m);
          csr_stream::stage_element(&ring[slot][tid], d.col_idx, d.m,
                                    start + clamp_to(rank, 0, d.budget - 1));
        }
        csr_stream::commit_stage();
        return unit;
      };
      Unit cur{0, 0};
      if (tiles > 0) cur = stage(0, 0);
      for (int s = 0; s < tiles; ++s) {
        const bool more = s + 1 < tiles;
        Unit next{0, 0};
        if (more) next = stage(s + 1, (s + 1) & 1);
        csr_stream::wait_stage(more);
        const int u = ua + s * kThreads + tid;
        if (u < ub) {
          const int nbr = ring[s & 1][tid];
          const int o = cur.owner;
          const int deg = scan[o] - (o > 0 ? scan[o - 1] : 0);
          const float contrib =
              __fdiv_rn(__fmul_rn(d.damping, __ldcg(d.lane_res + o)),
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
          ++kept_local;
        }
        d.scan_keep[p] = over ? id : -1;
      } else {
        const int l = p - d.n_check;
        if (items[l] != kEmpty && scan[l] > d.budget) ++kept_local;
      }
    }
    const int kept = block_sum<kThreads>(kept_local, warp_sums);
    if (tid == 0) d.block_count[blockIdx.x] = kept;
    publish_max();
    grid_barrier(d.barrier);

    // 8. the ring write at tail + rank, and the next condition's max
    const int head_after = wrap_add(head, k);
    const int free_slots = d.cap - wrap_sub(tail, head_after);
    const int count = ring_push<kThreads>(
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
    dropped = wrap_add(dropped, wrap_sub(count, pushed));
    tail = wrap_add(tail, pushed);
    head = head_after;
    work = wrap_add(work, n_proc);
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
    d.cursors[kSplits] = splits;
    d.cursors[kCounterRounds] = counter_rounds;
    d.cursors[kCheckCursor] = check_cursor;
    *d.units = units;
  }
}

// The launch plan for a wavefront of W: dynamic shared memory (0 when the
// wavefront goes to global scratch) and the co-resident grid.
cudaError_t plan(int W, size_t* dyn, int* grid) {
  DeviceInfo info;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, pagerank_drain);
  if (err != cudaSuccess) return err;
  const size_t wave = 2 * static_cast<size_t>(W) * sizeof(int);
  *dyn = wave + attr.sharedSizeBytes <= static_cast<size_t>(info.smem_optin)
             ? wave
             : 0;
  return cooperative_grid(reinterpret_cast<const void*>(pagerank_drain),
                          kThreads, *dyn, grid);
}

}  // namespace

// The grid the launch takes for a wavefront of W, and whether the wavefront
// lives in shared memory (1) or in global scratch of grid * 2 W ints (0).
// Returns the cudaError_t (0 on success).
extern "C" int pagerank_drain_grid(int wavefront, int* grid,
                                   int* wave_in_shared) {
  size_t dyn = 0;
  const cudaError_t err = plan(wavefront, &dyn, grid);
  if (err != cudaSuccess) return err;
  *wave_in_shared = dyn > 0;
  return cudaSuccess;
}

// One cooperative launch of the whole drain on `stream`.  `grid` and
// `wave_global` come from pagerank_drain_grid; the scratch is sized by the
// caller: first_lane n words of all ones; lane_res W floats; unit_nbr,
// unit_contrib, unit_place, seg and ordered budget words each; seg_count n
// zeroed ints; seg_start n ints; seg_cursor one int; scan_keep n_check
// ints; block_count grid ints; block_max grid floats; barrier 2 zeroed
// words; units one word, which gets the number of work units the drain expanded.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int pagerank_drain_launch(
    int* buf, int cap, float* rank, float* residue, unsigned char* in_queue,
    int n, const int* row_ptr, const int* col_idx, int m, int* cursors,
    int wavefront, int budget, int n_check, float damping, float eps,
    int max_rounds, unsigned long long* first_lane, float* lane_res,
    int* unit_nbr, float* unit_contrib, int* unit_place, int* seg,
    float* ordered, int* seg_count, int* seg_start, int* seg_cursor, int* scan_keep,
    int* block_count, float* block_max, unsigned int* barrier,
    int* wave_global, long long* units, int grid, cudaStream_t stream) {
  size_t dyn = 0;
  int most = 0;
  cudaError_t err = plan(wavefront, &dyn, &most);
  if (err != cudaSuccess) return err;
  if (grid < 1 || grid > most) return cudaErrorInvalidValue;
  if ((dyn == 0) != (wave_global != nullptr)) return cudaErrorInvalidValue;
  Drain d{buf,        cap,          rank,       residue,     in_queue,
          n,          row_ptr,      col_idx,    m,           cursors,
          wavefront,  budget,       n_check,    damping,     eps,
          max_rounds, first_lane,   lane_res,   unit_nbr,    unit_contrib,
          unit_place, seg,          ordered,    seg_count,   seg_start,
          seg_cursor, scan_keep,    block_count, block_max,  barrier,
          wave_global, units};
  void* args[] = {&d};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(pagerank_drain),
                                    dim3(grid), dim3(kThreads), args, dyn,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
