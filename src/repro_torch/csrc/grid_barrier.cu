// The drain kernels' grid barrier (drain_common.cuh) measured and checked
// alone.
//
// Replaces no TPU kernel: a TPU runs a kernel's grid in order on one core
// and needs no barrier between its steps, while the drain kernels B3 run
// every round of a drain inside one cooperative launch and part the round's
// phases with grid barriers (two to seven a round).  This source runs
// `rounds` rounds over a co-resident grid of 512-thread blocks, the drain
// kernels' block.  In round i:
//
//   * every thread makes a plain store of i + 1 to its own word of half
//     i % 2 of `stamps`, and thread 0 of every block adds 1 to word i % 3
//     of `words`;
//   * every block passes the barrier;
//   * every thread reads, with __ldcg, the word of the same thread of block
//     (b + 1 + i) % G in that half, and thread 0 the round word, and traps
//     unless they read i + 1 and G; block 0 zeroes the round word of round
//     i - 1 (read by every block before it reached this barrier, added to
//     again only after the next one).
//
// A half is written again two rounds on, after the next barrier, which no
// block passes before every block has read it.  So a barrier that lets a
// block through early, or that fails to publish a thread's plain store
// before it to a read after it in another block, traps.  The drains rely
// on just that: their block barriers and thread 0's release and acquire
// order every thread's writes, with no fence of a thread's own.
//
// Instances: drain_common.cuh's grid_barrier as the drain kernels take it,
// and cooperative groups' this_grid().sync() as the yardstick.  What bounds
// a barrier on an H100: the round trips of its arrival add and of the poll
// that sees the flip, through the L2, plus the two block barriers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "drain_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;

enum Instance { kDrain = 0, kGridSync = 1, kInstances };

template <int kInstance>
__global__ void __launch_bounds__(kThreads, 1)
    barrier_rounds(unsigned* bar, unsigned* words, unsigned* stamps,
                   int rounds) {
  const unsigned G = gridDim.x;
  const unsigned half = G * kThreads;
  for (int i = 0; i < rounds; ++i) {
    const unsigned stamp = static_cast<unsigned>(i) + 1u;
    unsigned* mine = stamps + (i & 1) * half;
    mine[blockIdx.x * kThreads + threadIdx.x] = stamp;
    if (threadIdx.x == 0) atomicAdd(words + i % 3, 1u);
    if constexpr (kInstance == kGridSync) {
      cg::this_grid().sync();
    } else {
      drain::grid_barrier(bar);
    }
    const unsigned peer = (blockIdx.x + 1u + static_cast<unsigned>(i)) % G;
    if (__ldcg(mine + peer * kThreads + threadIdx.x) != stamp) __trap();
    if (threadIdx.x == 0) {
      if (__ldcg(words + i % 3) != G) __trap();
      if (blockIdx.x == 0) words[(i + 2) % 3] = 0u;
    }
  }
}

const void* kernel_for(int instance) {
  return instance == kDrain
             ? reinterpret_cast<const void*>(barrier_rounds<kDrain>)
             : reinterpret_cast<const void*>(barrier_rounds<kGridSync>);
}

}  // namespace

// The co-resident grid of an instance at 512 threads a block, and the
// card's SM count.  Returns the cudaError_t (0 on success).
extern "C" int grid_barrier_grid(int instance, int* most, int* sms) {
  if (instance < 0 || instance >= kInstances) return cudaErrorInvalidValue;
  drain::DeviceInfo info;
  cudaError_t err = drain::device_info(&info);
  if (err != cudaSuccess) return err;
  *sms = info.sms;
  return drain::cooperative_grid(kernel_for(instance), kThreads, 0, most);
}

// One cooperative launch of `rounds` barrier rounds of `instance` over
// `grid` blocks on `stream`.  `bar` is one zeroed word (the barrier's
// arrivals), `words` three zeroed words (the round words) and `stamps`
// 2 * grid * 512 zeroed words (the threads' stores).  Returns the
// cudaError_t of the launch (0 on success); a miss traps in the launch.
extern "C" int grid_barrier_launch(int instance, unsigned* bar,
                                   unsigned* words, unsigned* stamps,
                                   int rounds, int grid, cudaStream_t stream) {
  int most = 0;
  int sms = 0;
  cudaError_t err =
      static_cast<cudaError_t>(grid_barrier_grid(instance, &most, &sms));
  if (err != cudaSuccess) return err;
  if (grid < 1 || grid > most || rounds < 0) return cudaErrorInvalidValue;
  void* args[] = {&bar, &words, &stamps, &rounds};
  err = cudaLaunchCooperativeKernel(kernel_for(instance), dim3(grid),
                                    dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
