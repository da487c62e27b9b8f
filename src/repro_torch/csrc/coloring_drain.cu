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
// A vertex has at most one task in the queue, so the commits have unique
// targets.  The forbidden colors of a vertex are a bitset of deg + 1 bits in
// shared memory (the pick never exceeds deg): a row of degree below 1024
// takes one warp and a 32-word bitset of its own, a larger row the whole
// block and a bitset sized for the graph's largest degree (12.8 KB at
// rmat(21)'s 102,430), so a hub is never left to one thread.  Detects are
// split the same way.  Five grid barriers a round (six at G > 1): after the
// picks, after the commits, after the detects, (after the window reads,)
// after the push counts and after the ring write.  Structure, barriers and
// the push are drain_common.cuh's.
//
// Modes.  The fused mode (B3-fused) drains lane 0 of the fused topology's
// one-lane MultiQueue: a popped word is unpacked to its task and a pushed
// task packed with job 0 (drain_common.cuh's lane_load / lane_store), which
// is what runtime/api.fused_lane_ops does around the same body.  The traced
// mode (B3-traced) writes one trace row a round from block 0 after the
// round's last barrier (drain_common.cuh's Tracer).  Each mode is a
// template argument, so the single, untraced instances are unchanged.
//
// What bounds the drain on an H100: bytes, 8 per neighbor visited (its
// col_idx word and its color) for every assign and every detect, and the
// barriers.  Right first, fast later.

#include <cuda_runtime.h>

#include "drain_common.cuh"

namespace {

using namespace drain;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSmallDeg = 1024;  // rows below this degree take one warp

struct Drain {
  int* buf;  // [cap] the task ring, updated in place
  int cap;
  int* colors;  // [n] updated in place
  int n;
  const int* row_ptr;  // [n + 1]
  const int* col_idx;  // [m]
  int* cursors;        // [kCursors]
  int wavefront;
  int max_rounds;
  Codec codec;
  Windows win;    // the re-assigns' chunk windows
  int* pick;      // [W G] the color each assign vertex lane picked
  int* bad;       // [W G] what a detect vertex lane pushes, plus one; 0 none
  int* block_count;       // [gridDim.x] push count of each block
  unsigned int* barrier;  // [2] arrivals, generation; zero at launch
  int* wave_global;  // [gridDim.x][W (1 + G)] when the wavefront and its
                     // vertex degrees do not fit in shared memory, else null
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

// Two blocks an SM where shared memory allows: at most 64 registers a
// thread.  kChunks = false is the G = 1 instance, whose codec is the
// compile-time identity: no division by G, no window code.  kPacked is the
// fused mode, kTraced the traced mode.
template <bool kChunks, bool kPacked, bool kTraced>
__global__ void __launch_bounds__(kThreads, 2) coloring_drain(Drain d) {
  extern __shared__ int dyn[];
  __shared__ unsigned warp_bits[kWarps][32];
  __shared__ int warp_sums[kWarps];
  __shared__ int s_pick;
  __shared__ int s_clash;
  const int W = d.wavefront;
  const Codec cc = kChunks ? d.codec : Codec{1, 0};
  const int WG = W * cc.G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = gridDim.x;
  const int gwarp = blockIdx.x * kWarps + warp;
  const int n_warps = G * kWarps;
  int* items;
  unsigned* big;
  if (d.wave_global) {
    items = d.wave_global + static_cast<size_t>(blockIdx.x) * (W + WG);
    big = reinterpret_cast<unsigned*>(dyn);
  } else {
    items = dyn;
    big = reinterpret_cast<unsigned*>(dyn + W + WG);
  }
  int* degs = items + W;  // [W G] a vertex lane's degree, -1 for none

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

  // the vertex of vertex lane f (valid where degs[f] >= 0)
  auto vertex_of = [&](int f) {
    return chunk_head(code_of(items[f / cc.G]), cc) + f % cc.G;
  };

  long long visits = 0;
  const int per_thread = (W + kThreads - 1) / kThreads;
  const int l0 = min(tid * per_thread, W);
  const int l1 = min(l0 + per_thread, W);
  const int per_thread_f = (WG + kThreads - 1) / kThreads;
  const int f0 = min(tid * per_thread_f, WG);
  const int f1 = min(f0 + per_thread_f, WG);
  while (rounds < d.max_rounds && rounds < limit && wrap_sub(tail, head) > 0) {
    const int size = wrap_sub(tail, head);
    const int k = size < W ? size : W;
    const int K = k * cc.G;  // vertex lanes in play
    const unsigned r = static_cast<unsigned>(rounds) + 1u;

    // 1. pop, each vertex lane's degree, the assign vertices
    int assign_local = 0;
    for (int l = l0; l < l1; ++l) {
      int item = kEmpty;
      if (l < k) {
        item = lane_load<kPacked>(
            __ldcg(d.buf + ring_slot(wrap_add(head, l), d.cap)));
        if (item > 0) assign_local += chunk_width(code_of(item), cc);
      }
      items[l] = item;
      if (!kChunks) {  // G = 1: lane l is vertex lane l, read here
        int deg = -1;
        if (l < k) {
          const int v = code_of(item);
          deg = __ldg(d.row_ptr + v + 1) - __ldg(d.row_ptr + v);
        }
        degs[l] = deg;
      }
    }
    if (kChunks) {
      __syncthreads();
      for (int f = f0; f < f1; ++f) {
        int deg = -1;
        if (f < K && f % cc.G < chunk_width(code_of(items[f / cc.G]), cc)) {
          const int v = vertex_of(f);
          deg = __ldg(d.row_ptr + v + 1) - __ldg(d.row_ptr + v);
        }
        degs[f] = deg;
      }
    }
    const int n_assign = block_sum<kThreads>(assign_local, warp_sums);

    // 2. picks from the round-start colors: small rows by warps ...
    for (int f = gwarp; f < K; f += n_warps) {
      const int item = items[f / cc.G];
      const int deg = degs[f];
      if (item <= 0 || deg < 0 || deg >= kSmallDeg) continue;
      const int v = vertex_of(f);
      const int lo = __ldg(d.row_ptr + v);
      unsigned* bits = warp_bits[warp];
      bits[lane] = 0u;
      __syncwarp();
      for (int j = lane; j < deg; j += 32) {
        const int c = __ldcg(d.colors + __ldg(d.col_idx + lo + j));
        if (c >= 0 && c <= deg) atomicOr(bits + (c >> 5), 1u << (c & 31));
      }
      __syncwarp();
      const unsigned fr = free_bits(bits[lane], lane, deg);
      const unsigned has = __ballot_sync(kFull, fr != 0u);
      const int first = __ffs(has) - 1;
      const unsigned ff = __shfl_sync(kFull, fr, first);
      if (lane == 0) d.pick[f] = first * 32 + __ffs(ff) - 1;
      visits += lane == 0 ? deg : 0;
      __syncwarp();  // the bitset is cleared for the next row
    }
    // ... large rows by whole blocks
    for (int f = blockIdx.x; f < K; f += G) {
      const int item = items[f / cc.G];
      const int deg = degs[f];
      if (item <= 0 || deg < kSmallDeg) continue;
      const int v = vertex_of(f);
      const int lo = __ldg(d.row_ptr + v);
      const int words = (deg + 32) / 32;  // deg + 1 bits
      for (int w = tid; w < words; w += kThreads) big[w] = 0u;
      if (tid == 0) s_pick = INT_MAX;
      __syncthreads();
      for (int j = tid; j < deg; j += kThreads) {
        const int c = __ldcg(d.colors + __ldg(d.col_idx + lo + j));
        if (c >= 0 && c <= deg) atomicOr(big + (c >> 5), 1u << (c & 31));
      }
      __syncthreads();
      for (int w = tid; w < words; w += kThreads) {
        const unsigned fr = free_bits(big[w], w, deg);
        if (fr != 0u) {
          atomicMin(&s_pick, w * 32 + __ffs(fr) - 1);
          break;
        }
      }
      __syncthreads();
      if (tid == 0) {
        d.pick[f] = s_pick;
        visits += deg;
      }
      __syncthreads();  // big and s_pick are reused by the next row
    }
    grid_barrier(d.barrier);

    // 3. commit this block's assign vertex lanes
    int fa, fb;
    block_range(K, blockIdx.x, G, fa, fb);
    for (int f = fa + tid; f < fb; f += kThreads) {
      if (items[f / cc.G] > 0 && degs[f] >= 0) {
        d.colors[vertex_of(f)] = __ldcg(d.pick + f);
      }
    }
    grid_barrier(d.barrier);

    // 4. detects on the post-commit colors: small rows by warps ...  A
    // vertex that re-colors pushes v + 1 at G = 1; at G > 1 it marks its
    // window, and what it pushes is read after a barrier.
    for (int f = gwarp; f < K; f += n_warps) {
      const int item = items[f / cc.G];
      const int deg = degs[f];
      if (item >= 0 || deg < 0 || deg >= kSmallDeg) continue;
      const int v = vertex_of(f);
      const int my = __ldcg(d.colors + v);
      const unsigned pv = priority(static_cast<unsigned>(v));
      const int lo = __ldg(d.row_ptr + v);
      bool clash = false;
      if (my >= 0) {
        for (int j = lane; j < deg; j += 32) {
          const int u = __ldg(d.col_idx + lo + j);
          clash |= __ldcg(d.colors + u) == my &&
                   beats(u, priority(static_cast<unsigned>(u)), v, pv);
        }
      }
      const bool any = __any_sync(kFull, clash);
      if (lane == 0) {
        d.bad[f] = !any ? 0 : (cc.G > 1 ? 1 : v + 1);
        if (any && cc.G > 1) window_add(d.win, v, cc, r);
        visits += my >= 0 ? deg : 0;
      }
    }
    // ... large rows by whole blocks
    for (int f = blockIdx.x; f < K; f += G) {
      const int item = items[f / cc.G];
      const int deg = degs[f];
      if (item >= 0 || deg < kSmallDeg) continue;
      const int v = vertex_of(f);
      const int my = __ldcg(d.colors + v);
      const unsigned pv = priority(static_cast<unsigned>(v));
      const int lo = __ldg(d.row_ptr + v);
      if (tid == 0) s_clash = 0;
      __syncthreads();
      if (my >= 0) {
        bool clash = false;
        for (int j = tid; j < deg; j += kThreads) {
          const int u = __ldg(d.col_idx + lo + j);
          clash |= __ldcg(d.colors + u) == my &&
                   beats(u, priority(static_cast<unsigned>(u)), v, pv);
        }
        if (clash) s_clash = 1;
      }
      __syncthreads();
      if (tid == 0) {
        d.bad[f] = !s_clash ? 0 : (cc.G > 1 ? 1 : v + 1);
        if (s_clash && cc.G > 1) window_add(d.win, v, cc, r);
        visits += my >= 0 ? deg : 0;
      }
      __syncthreads();  // s_clash is reused by the next row
    }
    grid_barrier(d.barrier);

    // 5. push: positions [0, k) the assigns' detects, [k, k + K) the
    // re-assigns by vertex lane; at G > 1 this block's re-assign positions
    // first read their windows
    const int P = k + K;
    int lo, hi;
    block_range(P, blockIdx.x, G, lo, hi);
    int kept_local = 0;
    for (int p = lo + tid; p < hi; p += kThreads) {
      if (p < k) {
        kept_local += items[p] > 0;
        continue;
      }
      const int f = p - k;
      // bad is written for the detect vertex lanes only
      const bool detect = items[f / cc.G] < 0 && degs[f] >= 0;
      int value = detect ? __ldcg(d.bad + f) : 0;
      if (value != 0 && cc.G > 1) {
        const int chunk = window_emit(d.win, vertex_of(f), cc, true);
        value = chunk >= 0 ? chunk + 1 : 0;
        d.bad[f] = value;
      }
      kept_local += value != 0;
    }
    const int kept = block_sum<kThreads>(kept_local, warp_sums);
    if (tid == 0) d.block_count[blockIdx.x] = kept;
    grid_barrier(d.barrier);

    const int head_after = wrap_add(head, k);
    const int free_slots = d.cap - wrap_sub(tail, head_after);
    const int count = ring_push<kThreads, kPacked>(
        d.buf, d.cap, tail, free_slots, d.block_count, lo, hi, warp_sums,
        [&](int p, int& value) {
          if (p < k) {
            value = wrap_sub(0, items[p]);  // -(c + 1) for an assign
            return items[p] > 0;
          }
          const int f = p - k;
          value = items[f / cc.G] < 0 && degs[f] >= 0 ? __ldcg(d.bad + f) : 0;
          return value != 0;
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
template <bool kChunks, bool kPacked>
const void* instance(bool traced) {
  return traced ? reinterpret_cast<const void*>(
                      coloring_drain<kChunks, kPacked, true>)
                : reinterpret_cast<const void*>(
                      coloring_drain<kChunks, kPacked, false>);
}

const void* kernel_for(int granularity, bool packed, bool traced) {
  if (granularity > 1) {
    return packed ? instance<true, true>(traced)
                  : instance<true, false>(traced);
  }
  return packed ? instance<false, true>(traced)
                : instance<false, false>(traced);
}

// The launch plan for a wavefront of W chunks of up to G vertices and a
// block bitset of `big_words` in a mode: dynamic shared memory and the
// co-resident grid.  The wavefront and its vertex lanes' degrees go to
// global scratch when they and the bitset do not fit in shared memory; a
// bitset that does not fit alone is refused.
cudaError_t plan(int W, int granularity, bool packed, bool traced,
                 int big_words, size_t* dyn, bool* wave_shared, int* grid) {
  const void* kernel = kernel_for(granularity, packed, traced);
  DeviceInfo info;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const size_t optin = static_cast<size_t>(info.smem_optin);
  const size_t bits = static_cast<size_t>(big_words) * sizeof(unsigned);
  const size_t wave =
      static_cast<size_t>(W) * (1 + granularity) * sizeof(int);
  if (bits + attr.sharedSizeBytes > optin) return cudaErrorInvalidValue;
  *wave_shared = wave + bits + attr.sharedSizeBytes <= optin;
  *dyn = (*wave_shared ? wave : 0) + bits;
  return cooperative_grid(kernel, kThreads, *dyn, grid);
}

}  // namespace

// The grid the launch takes for a wavefront of W chunks of up to G
// vertices and a graph whose largest degree is max_degree, in a mode
// (packed: the fused mode; traced: the traced mode), and whether the
// wavefront lives in shared memory (1) or in global scratch of grid * W
// (1 + G) ints (0).  Returns the cudaError_t (0 on success).
extern "C" int coloring_drain_grid(int wavefront, int granularity,
                                   int max_degree, int packed, int traced,
                                   int* grid, int* wave_in_shared) {
  size_t dyn = 0;
  bool shared = false;
  const cudaError_t err =
      plan(wavefront, granularity, packed != 0, traced != 0,
           (max_degree + 32) / 32, &dyn, &shared, grid);
  if (err != cudaSuccess) return err;
  *wave_in_shared = shared;
  return cudaSuccess;
}

// One cooperative launch of the whole drain on `stream`.  `grid` and
// `wave_global` come from coloring_drain_grid; the scratch is sized by the
// caller: pick and bad W G ints each; windows 3 (n / G + 2) zeroed words,
// then one zeroed split count; block_count grid ints; barrier 2 zeroed
// words; visits one zeroed word, which gets the neighbors the picks and
// detects visited.  `threshold` is the split threshold (INT_MAX for none).
// `packed` selects the fused mode
// (buf is lane 0 of a one-lane MultiQueue); a non-null `trace` the traced
// mode, with its [trace_capacity][13] rows and one-int cursor, both updated
// in place.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int coloring_drain_launch(
    int* buf, int cap, int* colors, int n, const int* row_ptr,
    const int* col_idx, int* cursors, int wavefront, int max_rounds,
    int max_degree, int granularity, int width_bits, int threshold,
    int* pick, int* bad, unsigned long long* windows, unsigned int* splits,
    int* block_count, unsigned int* barrier, int* wave_global,
    long long* visits, int packed, int* trace, int trace_capacity,
    int* trace_cursor, int grid, cudaStream_t stream) {
  const bool traced = trace != nullptr;
  if (granularity < 1 || granularity > 64) return cudaErrorInvalidValue;
  if (traced && (trace_capacity < 1 || trace_cursor == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int big_words = (max_degree + 32) / 32;
  size_t dyn = 0;
  bool shared = false;
  int most = 0;
  cudaError_t err = plan(wavefront, granularity, packed != 0, traced,
                         big_words, &dyn, &shared, &most);
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
  d.cursors = cursors;
  d.wavefront = wavefront;
  d.max_rounds = max_rounds;
  d.codec = Codec{granularity, width_bits};
  d.win = Windows{windows, windows + nb, windows + 2 * nb, splits, row_ptr,
                  n, threshold};
  d.pick = pick;
  d.bad = bad;
  d.block_count = block_count;
  d.barrier = barrier;
  d.wave_global = wave_global;
  d.visits = visits;
  d.trace = TraceRing{trace, trace_capacity, trace_cursor};
  void* args[] = {&d};
  err = cudaLaunchCooperativeKernel(
      kernel_for(granularity, packed != 0, traced), dim3(grid),
      dim3(kThreads), args, dyn, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
