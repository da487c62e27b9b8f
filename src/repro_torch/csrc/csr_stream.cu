// Double-buffered CSR row-slice stream, kernel B4.
//
// Replaces the TPU kernel `stream_row_slices` (body `_stream_kernel`) in
// src/repro/kernels/drain_loop/csr_stream.py.  For starts[W] it writes
//
//   out[i, j] = padded[clamp(starts[i], 0, m) + j]     for j < budget,
//
// where `padded` is col_idx[0 : m] followed by `budget` zeros: bit-equal to
// the plain version `stream_row_slices_ref`.
//
// What the TPU kernel did: one DMA per item, `col_idx[start : start +
// budget]` from HBM into a [2, budget] VMEM scratch, the copy of item i + 1
// in flight while item i is written out, with a DMA semaphore per slot.
//
// What bounds it on an H100: bytes.  It reads 4 W bytes of starts and
// 4 W budget bytes of col_idx, and writes 4 W budget bytes; there is no
// arithmetic.  Here the flat [W, budget] output is cut into tiles of kTile
// elements, and each block walks its tiles (blockIdx.x, + gridDim.x, ...)
// through the two-slot shared-memory ring of csr_stream.cuh: the cp.async
// copies of the next tile are issued before the current one is written out.
// Inside a row, neighbouring threads copy and store neighbouring words, so
// reads and writes coalesce.  The same staging function feeds the BFS drain
// kernel (bfs_drain.cu), so what is held against the plain version here is
// what the drain runs.

#include <cuda_runtime.h>

#include "csr_stream.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;  // elements per stage
constexpr int kBlocksPerSm = 4;

__global__ void __launch_bounds__(kThreads)
    stream_rows(const int* __restrict__ starts, int n_items,
                const int* __restrict__ col_idx, int m, int budget,
                int* __restrict__ out) {
  __shared__ int ring[csr_stream::kStages][kTile];
  const long long total = static_cast<long long>(n_items) * budget;
  const long long n_tiles = (total + kTile - 1) / kTile;

  auto issue = [&](long long tile, int slot) {
    for (int p = 0; p < kPerThread; ++p) {
      const int j = p * kThreads + threadIdx.x;
      const long long flat = tile * kTile + j;
      if (flat < total) {
        const int i = static_cast<int>(flat / budget);
        const long long r = flat - static_cast<long long>(i) * budget;
        const long long start = csr_stream::slice_start(__ldg(starts + i), m);
        csr_stream::stage_element(&ring[slot][j], col_idx, m, start + r);
      }
    }
    csr_stream::commit_stage();
  };

  long long tile = blockIdx.x;
  if (tile >= n_tiles) return;
  issue(tile, 0);
  for (int s = 0; tile < n_tiles; ++s, tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    const bool more = next < n_tiles;
    if (more) issue(next, (s + 1) & 1);
    csr_stream::wait_stage(more);
    for (int p = 0; p < kPerThread; ++p) {
      const int j = p * kThreads + threadIdx.x;
      const long long flat = tile * kTile + j;
      if (flat < total) out[flat] = ring[s & 1][j];
    }
    __syncthreads();  // slot s & 1 is refilled by stage s + 2
  }
}

constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];

}  // namespace

// out holds n_items * budget ints; n_items and budget are positive and
// m + budget < 2^31.  Launches on `stream`; returns the cudaError_t of the
// launch (0 on success).
extern "C" int csr_stream_launch(const int* starts, int n_items,
                                 const int* col_idx, int m, int budget,
                                 int* out, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  const long long total = static_cast<long long>(n_items) * budget;
  const long long n_tiles = (total + kTile - 1) / kTile;
  const long long most = static_cast<long long>(g_sms[dev]) * kBlocksPerSm;
  const int blocks = static_cast<int>(n_tiles < most ? n_tiles : most);
  stream_rows<<<blocks, kThreads, 0, stream>>>(starts, n_items, col_idx, m,
                                               budget, out);
  return cudaGetLastError();
}
