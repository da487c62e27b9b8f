// The ordered scatter-add: PageRank's deterministic `.at[].add`.
//
// Replaces no TPU kernel.  `residue.at[nbr].add(contrib)` in
// src/repro/algorithms/pagerank.py:122 runs on XLA's CPU backend as a loop
// over the updates in order, so each slot gets ((r + c1) + c2) + ... in
// update order.  Atomics on the card add in an order that changes from run
// to run, and float addition does not associate, so the low bits of the
// ranks would change with it.  This kernel adds in update order:
//
//   out[keys[i]] = base + values[order[i]] for i over the run of equal keys,
//                  left to right
//
// where (keys, order) is the stable sort of the update indices (made by the
// wrapper with torch.sort(stable=True)), and `out` enters holding `base`.
// Thread i starts a run when keys[i] differs from keys[i - 1]; it alone
// reads and writes out[keys[i]], so no two threads touch one slot.
//
// What bounds it on an H100: bytes, and the longest run.  It reads the
// sorted keys (4 bytes), the order (4) and, through the order, the values
// (4, scattered) of every update, and reads and writes each touched slot
// once.  A run is summed by one thread, so a slot with many updates costs
// their count in dependent adds; on PageRank's rounds a slot gets a few
// hundred at the most (the hub's share of a round's edges).  Loads of the
// next eight values are issued before their adds, so a long run is bound
// by the add chain and not by the loads' latency.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 8;

__global__ void ordered_scatter_add(float* __restrict__ out, int n,
                                    const int* __restrict__ keys,
                                    const int* __restrict__ order,
                                    const float* __restrict__ values, int k) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= k) return;
  const int key = keys[i];
  if (i > 0 && keys[i - 1] == key) return;
  if (key < 0 || key >= n) return;  // the wrapper's contract: in range
  float acc = out[key];
  int j = i;
  while (j < k && keys[j] == key) {
    float v[kAhead];
    int len = 0;
#pragma unroll
    for (int t = 0; t < kAhead; ++t) {
      const bool in = j + t < k && keys[j + t] == key;
      v[t] = in ? values[order[j + t]] : 0.0f;
      len += in;
    }
#pragma unroll
    for (int t = 0; t < kAhead; ++t) {
      if (t < len) acc = __fadd_rn(acc, v[t]);
    }
    j += len;
  }
  out[key] = acc;
}

}  // namespace

// out[n] holds the base and gets the sums; keys[k] and order[k] are the
// stable sort of the update indices and its permutation; values[k] the
// updates in their original order.  Returns the cudaError_t of the launch.
extern "C" int ordered_scatter_add_launch(float* out, int n, const int* keys,
                                          const int* order,
                                          const float* values, int k,
                                          cudaStream_t stream) {
  if (k <= 0) return cudaSuccess;
  const int blocks = (k + kThreads - 1) / kThreads;
  ordered_scatter_add<<<blocks, kThreads, 0, stream>>>(out, n, keys, order,
                                                       values, k);
  return cudaGetLastError();
}
