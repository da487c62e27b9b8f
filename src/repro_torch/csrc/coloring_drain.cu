// Speculative greedy coloring's whole drain in one cooperative launch,
// kernel B3-col.
//
// Replaces the TPU kernel `make_fused_drain` / `fused_drain_pallas`
// (pallas_call at src/repro/kernels/drain_loop/kernel.py:121) for the
// coloring program at granularity 1.  It computes exactly what the port's
// plain fused drain (`fused_drain_ref` over `wavefront_step` with the fused
// assign/detect body) computes, while
//
//   rounds < min(max_rounds, limit) and tail - head > 0:
//
//   1. pop      items[l] = buf[(head + l) % cap] for l < k = min(size, W);
//               +(v + 1) assigns v, -(v + 1) detects v;
//   2. pick     for every assign: the smallest color in [0, deg(v)] that no
//               neighbor holds, read from the round-start colors (all picks
//               are made before any is committed);
//   3. commit   colors[v] = pick;
//   4. detect   for every detect: v re-colors if a neighbor u holds v's
//               (post-commit) color and wins the (hash, id) order;
//   5. push     [-(v + 1) of every assign, wavefront order] ++ [+(v + 1) of
//               every detect that re-colors, wavefront order] into the ring
//               at tail + rank (ranks from prefix sums), the excess dropped;
//   6. counters work += assigns, processed += k, rounds and the
//               WorkCounter's rounds += 1.
//
// A vertex has at most one task in the queue, so the commits have unique
// targets.  The forbidden colors of a vertex are a bitset of deg + 1 bits in
// shared memory (the pick never exceeds deg): a row of degree below 1024
// takes one warp and a 32-word bitset of its own, a larger row the whole
// block and a bitset sized for the graph's largest degree (12.8 KB at
// rmat(21)'s 102,430), so a hub is never left to one thread.  Detects are
// split the same way.  Five grid barriers a round: after the picks, after
// the commits, after the detects, after the push counts and after the ring
// write.  Structure, barriers and the push are drain_common.cuh's.
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
  int big_words;          // words of the block bitset: (max deg + 32) / 32
  int* pick;              // [W] the color each assign lane picked
  int* bad;               // [W] 1 where a detect lane re-colors
  int* block_count;       // [gridDim.x] push count of each block
  unsigned int* barrier;  // [2] arrivals, generation; zero at launch
  int* wave_global;  // [gridDim.x][2 W] when the wavefront does not fit in
                     // shared memory, else null
  long long* visits;  // out: neighbors visited by the picks and detects
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

__global__ void __launch_bounds__(kThreads, 1) coloring_drain(Drain d) {
  extern __shared__ int dyn[];
  __shared__ unsigned warp_bits[kWarps][32];
  __shared__ int warp_sums[kWarps];
  __shared__ int s_pick;
  __shared__ int s_clash;
  const int W = d.wavefront;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = gridDim.x;
  const int gwarp = blockIdx.x * kWarps + warp;
  const int n_warps = G * kWarps;
  int* items;
  unsigned* big;
  if (d.wave_global) {
    items = d.wave_global + static_cast<size_t>(blockIdx.x) * 2 * W;
    big = reinterpret_cast<unsigned*>(dyn);
  } else {
    items = dyn;
    big = reinterpret_cast<unsigned*>(dyn + 2 * W);
  }
  int* degs = items + W;

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

  long long visits = 0;
  const int per_thread = (W + kThreads - 1) / kThreads;
  const int l0 = min(tid * per_thread, W);
  const int l1 = min(l0 + per_thread, W);
  while (rounds < d.max_rounds && rounds < limit && wrap_sub(tail, head) > 0) {
    const int size = wrap_sub(tail, head);
    const int k = size < W ? size : W;

    // 1. pop, each lane's vertex degree, the assign count
    int assign_local = 0;
    for (int l = l0; l < l1; ++l) {
      int item = kEmpty;
      int deg = 0;
      if (l < k) {
        item = __ldcg(d.buf + ring_slot(wrap_add(head, l), d.cap));
        const int v = item > 0 ? item - 1 : wrap_sub(-1, item);
        deg = __ldg(d.row_ptr + v + 1) - __ldg(d.row_ptr + v);
        assign_local += item > 0;
      }
      items[l] = item;
      degs[l] = deg;
    }
    const int n_assign = block_sum<kThreads>(assign_local, warp_sums);

    // 2. picks from the round-start colors: small rows by warps ...
    for (int l = gwarp; l < k; l += n_warps) {
      const int item = items[l];
      const int deg = degs[l];
      if (item <= 0 || deg >= kSmallDeg) continue;
      const int v = item - 1;
      const int lo = __ldg(d.row_ptr + v);
      unsigned* bits = warp_bits[warp];
      bits[lane] = 0u;
      __syncwarp();
      for (int j = lane; j < deg; j += 32) {
        const int c = __ldcg(d.colors + __ldg(d.col_idx + lo + j));
        if (c >= 0 && c <= deg) atomicOr(bits + (c >> 5), 1u << (c & 31));
      }
      __syncwarp();
      const unsigned f = free_bits(bits[lane], lane, deg);
      const unsigned has = __ballot_sync(kFull, f != 0u);
      const int first = __ffs(has) - 1;
      const unsigned ff = __shfl_sync(kFull, f, first);
      if (lane == 0) d.pick[l] = first * 32 + __ffs(ff) - 1;
      visits += lane == 0 ? deg : 0;
      __syncwarp();  // the bitset is cleared for the next row
    }
    // ... large rows by whole blocks
    for (int l = blockIdx.x; l < k; l += G) {
      const int item = items[l];
      const int deg = degs[l];
      if (item <= 0 || deg < kSmallDeg) continue;
      const int v = item - 1;
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
        const unsigned f = free_bits(big[w], w, deg);
        if (f != 0u) {
          atomicMin(&s_pick, w * 32 + __ffs(f) - 1);
          break;
        }
      }
      __syncthreads();
      if (tid == 0) {
        d.pick[l] = s_pick;
        visits += deg;
      }
      __syncthreads();  // big and s_pick are reused by the next row
    }
    grid_barrier(d.barrier);

    // 3. commit this block's assign lanes
    int la, lb;
    block_range(k, blockIdx.x, G, la, lb);
    for (int l = la + tid; l < lb; l += kThreads) {
      const int item = items[l];
      if (item > 0) d.colors[item - 1] = __ldcg(d.pick + l);
    }
    grid_barrier(d.barrier);

    // 4. detects on the post-commit colors: small rows by warps ...
    for (int l = gwarp; l < k; l += n_warps) {
      const int item = items[l];
      const int deg = degs[l];
      if (item >= 0 || deg >= kSmallDeg) continue;
      const int v = wrap_sub(-1, item);
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
        d.bad[l] = any;
        visits += my >= 0 ? deg : 0;
      }
    }
    // ... large rows by whole blocks
    for (int l = blockIdx.x; l < k; l += G) {
      const int item = items[l];
      const int deg = degs[l];
      if (item >= 0 || deg < kSmallDeg) continue;
      const int v = wrap_sub(-1, item);
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
        d.bad[l] = s_clash;
        visits += my >= 0 ? deg : 0;
      }
      __syncthreads();  // s_clash is reused by the next row
    }
    grid_barrier(d.barrier);

    // 5. push: positions [0, k) the assigns' detects, [k, 2k) the re-colors
    const int P = 2 * k;
    int lo, hi;
    block_range(P, blockIdx.x, G, lo, hi);
    int kept_local = 0;
    for (int p = lo + tid; p < hi; p += kThreads) {
      const int l = p < k ? p : p - k;
      const int item = items[l];
      kept_local += p < k ? item > 0 : (item < 0 && __ldcg(d.bad + l) != 0);
    }
    const int kept = block_sum<kThreads>(kept_local, warp_sums);
    if (tid == 0) d.block_count[blockIdx.x] = kept;
    grid_barrier(d.barrier);

    const int head_after = wrap_add(head, k);
    const int free_slots = d.cap - wrap_sub(tail, head_after);
    const int count = ring_push<kThreads>(
        d.buf, d.cap, tail, free_slots, d.block_count, lo, hi, warp_sums,
        [&](int p, int& value) {
          const int l = p < k ? p : p - k;
          const int item = items[l];
          value = wrap_sub(0, item);  // -(v + 1) for an assign, v + 1 back
          return p < k ? item > 0 : (item < 0 && __ldcg(d.bad + l) != 0);
        });
    grid_barrier(d.barrier);

    // 6. cursors and counters, the same in every block
    const int pushed = count < free_slots ? count : free_slots;
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
    d.cursors[kSplits] = splits;
    d.cursors[kCounterRounds] = counter_rounds;
  }
}

// The launch plan for a wavefront of W and a block bitset of `big_words`:
// dynamic shared memory and the co-resident grid.  The wavefront and its
// degrees go to global scratch when they and the bitset do not fit in
// shared memory; a bitset that does not fit alone is refused.
cudaError_t plan(int W, int big_words, size_t* dyn, bool* wave_shared,
                 int* grid) {
  DeviceInfo info;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, coloring_drain);
  if (err != cudaSuccess) return err;
  const size_t optin = static_cast<size_t>(info.smem_optin);
  const size_t bits = static_cast<size_t>(big_words) * sizeof(unsigned);
  const size_t wave = 2 * static_cast<size_t>(W) * sizeof(int);
  if (bits + attr.sharedSizeBytes > optin) return cudaErrorInvalidValue;
  *wave_shared = wave + bits + attr.sharedSizeBytes <= optin;
  *dyn = (*wave_shared ? wave : 0) + bits;
  return cooperative_grid(reinterpret_cast<const void*>(coloring_drain),
                          kThreads, *dyn, grid);
}

}  // namespace

// The grid the launch takes for a wavefront of W and a graph whose largest
// degree is max_degree, and whether the wavefront lives in shared memory
// (1) or in global scratch of grid * 2 W ints (0).  Returns the cudaError_t
// (0 on success).
extern "C" int coloring_drain_grid(int wavefront, int max_degree, int* grid,
                                   int* wave_in_shared) {
  size_t dyn = 0;
  bool shared = false;
  const cudaError_t err =
      plan(wavefront, (max_degree + 32) / 32, &dyn, &shared, grid);
  if (err != cudaSuccess) return err;
  *wave_in_shared = shared;
  return cudaSuccess;
}

// One cooperative launch of the whole drain on `stream`.  `grid` and
// `wave_global` come from coloring_drain_grid; the scratch is sized by the
// caller: pick and bad W ints each; block_count grid ints; barrier 2 zeroed
// words; visits one zeroed word, which gets the neighbors the picks and
// detects visited.  Returns the cudaError_t of the launch (0 on success).
extern "C" int coloring_drain_launch(int* buf, int cap, int* colors, int n,
                                     const int* row_ptr, const int* col_idx,
                                     int* cursors, int wavefront,
                                     int max_rounds, int max_degree,
                                     int* pick, int* bad, int* block_count,
                                     unsigned int* barrier, int* wave_global,
                                     long long* visits, int grid,
                                     cudaStream_t stream) {
  const int big_words = (max_degree + 32) / 32;
  size_t dyn = 0;
  bool shared = false;
  int most = 0;
  cudaError_t err = plan(wavefront, big_words, &dyn, &shared, &most);
  if (err != cudaSuccess) return err;
  if (grid < 1 || grid > most) return cudaErrorInvalidValue;
  if (shared != (wave_global == nullptr)) return cudaErrorInvalidValue;
  Drain d{buf,       cap,        colors,      n,       row_ptr,
          col_idx,   cursors,    wavefront,   max_rounds, big_words,
          pick,      bad,        block_count, barrier, wave_global,
          visits};
  void* args[] = {&d};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(coloring_drain),
                                    dim3(grid), dim3(kThreads), args, dyn,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
