// Speculative BFS's whole drain in one cooperative launch, kernel B3.
//
// Replaces the TPU kernel `make_fused_drain` / `fused_drain_pallas`
// (pallas_call at src/repro/kernels/drain_loop/kernel.py:121) for the BFS
// program at granularity 1 with merge-path expansion.  The Pallas kernel
// traced the persistent drain's `while cond: step` loop to a jaxpr and
// evaluated it inside the kernel body with `jax.core.eval_jaxpr`, so one
// kernel served any program.  Nothing on the GPU evaluates a jaxpr; this is
// the BFS program written out by hand, one launch per drain.  It computes
// exactly what the port's plain fused drain (`fused_drain_ref` over
// `wavefront_step` with the merge-path BFS body) computes, while
//
//   rounds < min(max_rounds, limit) and tail - head > 0:
//
//   1. pop      items[l] = buf[(head + l) % cap] for l < k = min(size, W);
//   2. scan     the inclusive int32 scan of the items' degrees; total;
//   3. truncate truncated[l] = valid & scan[l] > budget;
//   4. expand   every work unit u < min(total, budget): owner by an
//               upper-bound search of the scan (kernel B1's search), rank,
//               src, and nbr from the row slice staged by the stream of
//               csr_stream.cuh (kernel B4's staging);
//   5. relax    cand = dist[src] + 1 and before = dist[nbr], both read from
//               the round-start dist; improved = live & cand < before;
//               atomicMin(&dist[nbr], cand);
//   6. dedup    of the improved units with one nbr only the lowest stays:
//               atomicMin of ((max_rounds - round) << 32 | unit) on a 64-bit
//               word per vertex.  Keys fall from round to round, so the
//               array needs no reset;
//   7. push     [nbr of kept units, unit order] ++ [truncated items, wavefront
//               order] into the ring at tail + rank, ranks from prefix sums
//               (never an atomic ticket), so the ring is bit-identical to
//               TaskQueue.push; what exceeds cap - size is dropped and
//               counted;
//   8. counters work += k - #truncated, processed += k, rounds and the
//               WorkCounter's rounds += 1.
//
// Structure.  The grid is as many blocks as fit on the card at once
// (occupancy x SMs) and is launched with cudaLaunchCooperativeKernel, which
// refuses a grid that could not be co-resident instead of hanging.  Every
// block pops and scans the whole wavefront itself, into shared memory, so
// the wavefront costs no grid barrier, and every block keeps the cursors in
// registers and updates them identically, so the loop condition is the same
// in every block.  The round's push positions (the work units up to
// min(total, budget), then the wavefront's items) are cut into one
// contiguous range per block; each block expands, dedups and pushes its own
// range, in tiles of one unit per thread.  Four grid barriers a round: after
// the reads of step 5 (before any atomicMin), after the atomicMins (before
// the dedup reads them), after the per-block push counts, and after the ring
// write (before the next pop).  The barrier is a counter and a generation
// word in device memory, with no -rdc build; a barrier that has not
// completed after about half a minute traps, so a fault ends the launch with
// an error instead of holding the card.  Values that other blocks write
// inside the launch (dist, the ring, the dedup words, the push counts) are
// read with ld.global.cg, past the SM's incoherent L1.
//
// What bounds the drain on an H100: bytes, about 8 bytes per expanded edge
// (its col_idx word and dist[nbr]) plus the ring traffic, and the grid
// barriers, four per round.  The first form keeps it simple: the kernel is
// right first, and TMA, warp specialisation and fewer barriers are later
// work.

#include <cuda_runtime.h>

#include <climits>

#include "csr_stream.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEmpty = INT_MIN;  // core/queue.EMPTY
constexpr unsigned kSpinLimit = 1u << 28;

// The carry's scalars, in the order the Python wrapper packs them.
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
  int budget;
  int max_rounds;
  int* unit_nbr;   // [budget] nbr of an improved unit, else -1
  int* unit_cand;  // [budget] its candidate distance
  unsigned long long* first_unit;  // [n] dedup words, all ones at launch
  int* block_count;                // [gridDim.x] push count of each block
  unsigned int* barrier;           // [2] arrivals, generation; zero at launch
  int* wave_global;  // [gridDim.x][2 W] when the wavefront does not fit in
                     // shared memory, else null
  long long* units;  // out: work units expanded through the stream
};

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// Python's modulo, as torch's `%` takes it on int32.
__device__ __forceinline__ int ring_slot(int cursor, int cap) {
  const int r = cursor % cap;
  return r < 0 ? r + cap : r;
}

__device__ __forceinline__ int clamp_to(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ void grid_barrier(unsigned int* bar) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int seen = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      unsigned spins = 0;
      while (*gen == seen) {
        __nanosleep(100);
        if (++spins > kSpinLimit) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// Exclusive scan of one int a thread over the block, with int32 wraparound;
// `total` gets the block's sum.  Every thread of the block must call it.
__device__ int block_exclusive_scan(int v, int* warp_sums, int& total) {
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

__device__ __forceinline__ int block_sum(int v, int* warp_sums) {
  int total;
  block_exclusive_scan(v, warp_sums, total);
  return total;
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

struct Unit {
  int owner;
  int src;
};

__global__ void __launch_bounds__(kThreads, 1) bfs_drain(Drain d) {
  extern __shared__ int dyn[];
  __shared__ int ring[csr_stream::kStages][kThreads];
  __shared__ int warp_sums[kWarps];
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
  // every block has read the cursors before block 0 may write them back
  grid_barrier(d.barrier);

  long long units = 0;
  const int per_thread = (W + kThreads - 1) / kThreads;
  const int l0 = min(tid * per_thread, W);
  const int l1 = min(l0 + per_thread, W);
  while (rounds < d.max_rounds && rounds < limit && wrap_sub(tail, head) > 0) {
    const int size = wrap_sub(tail, head);
    const int k = size < W ? size : W;

    // 1-3. pop, degrees, inclusive scan, truncation: this block's own copy
    unsigned run = 0;
    for (int l = l0; l < l1; ++l) {
      int item = kEmpty;
      int deg = 0;
      if (l < k) {
        item = __ldcg(d.buf + ring_slot(wrap_add(head, l), d.cap));
        const int lo = clamp_to(item, 0, d.n);
        const int hi = clamp_to(wrap_add(lo, 1), 0, d.n);
        deg = wrap_sub(__ldg(d.row_ptr + hi), __ldg(d.row_ptr + lo));
      }
      items[l] = item;
      scan[l] = deg;
      run += static_cast<unsigned>(deg);
    }
    int unused;
    unsigned acc = static_cast<unsigned>(
        block_exclusive_scan(static_cast<int>(run), warp_sums, unused));
    int trunc_local = 0;
    for (int l = l0; l < l1; ++l) {
      acc += static_cast<unsigned>(scan[l]);
      scan[l] = static_cast<int>(acc);
      if (l < k && static_cast<int>(acc) > d.budget) ++trunc_local;
    }
    const int n_trunc = block_sum(trunc_local, warp_sums);  // syncs scan[]
    const int total = scan[W - 1];
    const int L = total < 0 ? 0 : (total < d.budget ? total : d.budget);
    units += L;

    // this block's range of push positions: units [0, L), then items
    const int P = L + k;
    const long long per_block = (static_cast<long long>(P) + G - 1) / G;
    const int lo = static_cast<int>(
        min(static_cast<long long>(blockIdx.x) * per_block,
            static_cast<long long>(P)));
    const int hi = static_cast<int>(
        min(static_cast<long long>(lo) + per_block, static_cast<long long>(P)));
    const int a_hi = min(hi, L);
    const int tiles_a = a_hi > lo ? (a_hi - lo + kThreads - 1) / kThreads : 0;

    // 4-5. expand through the row-slice stream; read, do not write, dist
    auto stage = [&](int s, int slot) {
      Unit unit{0, 0};
      const int u = lo + s * kThreads + tid;
      if (u < a_hi) {
        unit.owner = upper_bound(scan, W, u);
        const int rank = u - (unit.owner > 0 ? scan[unit.owner - 1] : 0);
        unit.src = unit.owner < k ? items[unit.owner] : 0;
        const long long start =
            csr_stream::slice_start(__ldg(d.row_ptr + unit.src), d.m);
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
        d.unit_nbr[u] = improved ? nbr : -1;
        d.unit_cand[u] = cand;
      }
      __syncthreads();  // slot s & 1 is refilled by stage s + 2
      cur = next;
    }
    grid_barrier(d.barrier);

    // 5-6. relax and claim the dedup word
    const unsigned long long stamp =
        static_cast<unsigned long long>(
            static_cast<unsigned>(wrap_sub(d.max_rounds, rounds)))
        << 32;
    for (int u = lo + tid; u < a_hi; u += kThreads) {
      const int nbr = d.unit_nbr[u];
      if (nbr >= 0) {
        atomicMin(d.dist + nbr, d.unit_cand[u]);
        atomicMin(d.first_unit + nbr, stamp | static_cast<unsigned>(u));
      }
    }
    grid_barrier(d.barrier);

    // 6-7. keep the first unit of each nbr; count this block's pushes
    int kept_local = 0;
    for (int u = lo + tid; u < a_hi; u += kThreads) {
      const int nbr = d.unit_nbr[u];
      if (nbr >= 0) {
        if (__ldcg(d.first_unit + nbr) != (stamp | static_cast<unsigned>(u))) {
          d.unit_nbr[u] = -1;
        } else {
          ++kept_local;
        }
      }
    }
    for (int p = max(lo, L) + tid; p < hi; p += kThreads) {
      if (scan[p - L] > d.budget) ++kept_local;
    }
    const int kept = block_sum(kept_local, warp_sums);
    if (tid == 0) d.block_count[blockIdx.x] = kept;
    grid_barrier(d.barrier);

    // 7. this block's offset and the round's push count, then the ring write
    int base = 0;
    int count = 0;
    for (int c0 = 0; c0 < G; c0 += kThreads) {
      const int b = c0 + tid;
      const int v = b < G ? __ldcg(d.block_count + b) : 0;
      base = wrap_add(base, block_sum(b < static_cast<int>(blockIdx.x) ? v : 0,
                                      warp_sums));
      count = wrap_add(count, block_sum(v, warp_sums));
    }
    const int head_after = wrap_add(head, k);
    const int free_slots = d.cap - wrap_sub(tail, head_after);
    const int tiles_p = hi > lo ? (hi - lo + kThreads - 1) / kThreads : 0;
    int offset = base;
    for (int s = 0; s < tiles_p; ++s) {
      const int p = lo + s * kThreads + tid;
      int keep = 0;
      int value = 0;
      if (p < hi) {
        if (p < L) {
          value = d.unit_nbr[p];
          keep = value >= 0;
        } else {
          keep = scan[p - L] > d.budget;
          value = items[p - L];
        }
      }
      int tile_total;
      const int r =
          wrap_add(offset, block_exclusive_scan(keep, warp_sums, tile_total));
      if (keep && r < free_slots) {
        d.buf[ring_slot(wrap_add(tail, r), d.cap)] = value;
      }
      offset = wrap_add(offset, tile_total);
    }
    grid_barrier(d.barrier);

    // 8. cursors and counters, the same in every block
    const int pushed = count < free_slots ? count : free_slots;
    dropped = wrap_add(dropped, wrap_sub(count, pushed));
    tail = wrap_add(tail, pushed);
    head = head_after;
    work = wrap_add(work, k - n_trunc);
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
    d.cursors[kSplits] = splits;
    d.cursors[kCounterRounds] = counter_rounds;
    *d.units = units;
  }
}

struct DeviceInfo {
  int sms = 0;
  int smem_optin = 0;
  int cooperative = 0;
  int smem_set = 48 * 1024;  // dynamic shared memory bfs_drain may use
};
constexpr int kMaxDevices = 64;
DeviceInfo g_info[kMaxDevices];

// The launch plan for a wavefront of W: dynamic shared memory (0 when the
// wavefront goes to global scratch) and the co-resident grid.
cudaError_t plan(int W, size_t* dyn, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& info = g_info[dev];
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
  if (!info.cooperative) return cudaErrorNotSupported;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, bfs_drain);
  if (err != cudaSuccess) return err;
  const size_t wave = 2 * static_cast<size_t>(W) * sizeof(int);
  *dyn = wave + attr.sharedSizeBytes <= static_cast<size_t>(info.smem_optin)
             ? wave
             : 0;
  if (*dyn > static_cast<size_t>(info.smem_set)) {
    err = cudaFuncSetAttribute(bfs_drain,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(*dyn));
    if (err != cudaSuccess) return err;
    info.smem_set = static_cast<int>(*dyn);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bfs_drain,
                                                      kThreads, *dyn);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = per_sm * info.sms;
  return cudaSuccess;
}

}  // namespace

// The grid the launch takes for a wavefront of W, and whether the wavefront
// lives in shared memory (1) or in global scratch of grid * 2 W ints (0).
// Returns the cudaError_t (0 on success).
extern "C" int bfs_drain_grid(int wavefront, int* grid, int* wave_in_shared) {
  size_t dyn = 0;
  const cudaError_t err = plan(wavefront, &dyn, grid);
  if (err != cudaSuccess) return err;
  *wave_in_shared = dyn > 0;
  return cudaSuccess;
}

// One cooperative launch of the whole drain on `stream`.  `grid` and
// `wave_global` come from bfs_drain_grid; the scratch is sized by the caller
// (unit_nbr and unit_cand: budget ints; first_unit: n words of all ones;
// block_count: grid ints; barrier: 2 zeroed words; units: one word, which
// gets the number of work units the drain expanded).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int bfs_drain_launch(int* buf, int cap, int* dist, int n,
                                const int* row_ptr, const int* col_idx, int m,
                                int* cursors, int wavefront, int budget,
                                int max_rounds, int* unit_nbr, int* unit_cand,
                                unsigned long long* first_unit,
                                int* block_count, unsigned int* barrier,
                                int* wave_global, long long* units,
                                int grid, cudaStream_t stream) {
  size_t dyn = 0;
  int most = 0;
  cudaError_t err = plan(wavefront, &dyn, &most);
  if (err != cudaSuccess) return err;
  if (grid < 1 || grid > most) return cudaErrorInvalidValue;
  if ((dyn == 0) != (wave_global != nullptr)) return cudaErrorInvalidValue;
  Drain d{buf,       cap,       dist,       n,           row_ptr,
          col_idx,   m,         cursors,    wavefront,   budget,
          max_rounds, unit_nbr, unit_cand,  first_unit,  block_count,
          barrier,   wave_global, units};
  void* args[] = {&d};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(bfs_drain),
                                    dim3(grid), dim3(kThreads), args, dyn,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
