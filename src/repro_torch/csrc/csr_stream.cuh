// The row-slice stream: staging shared by kernels B4 (csr_stream.cu) and B3
// (bfs_drain.cu).
//
// Element (i, j) of the stream is `padded[clamp(starts[i], 0, m) + j]`, where
// `padded` is `col_idx[0 : m]` followed by zeros: the reference's
// `stream_row_slices` (src/repro/kernels/drain_loop/csr_stream.py:72).  A
// stage is one slot of a two-slot shared-memory ring.  Each thread of a block
// issues the copies of its own elements of a stage with `cp.async` and
// commits them as one group, so the copies of stage s + 1 are in flight while
// stage s is consumed.  Starts are arbitrary, so every copy is one 4-byte
// word; indices at or past `m` store 0 instead of copying.
#pragma once

#include <cuda_pipeline.h>

namespace csr_stream {

constexpr int kStages = 2;

// First column index of a slice: its start clamped into [0, m], as the
// reference clamps it.
__device__ __forceinline__ long long slice_start(int start, int m) {
  return start < 0 ? 0 : (start > m ? m : start);
}

// Issue the copy of padded[e] into `dst`, a word of shared memory.
__device__ __forceinline__ void stage_element(int* dst,
                                              const int* __restrict__ col_idx,
                                              long long m, long long e) {
  if (e < m) {
    __pipeline_memcpy_async(dst, col_idx + e, sizeof(int));
  } else {
    *dst = 0;
  }
}

// Close the calling thread's copies of one stage.  Every thread of the block
// commits once per stage, whether it issued a copy or not.
__device__ __forceinline__ void commit_stage() { __pipeline_commit(); }

// Wait until the older stage has landed for the whole block.
// `newer_in_flight` says whether a later stage was committed after it.
__device__ __forceinline__ void wait_stage(bool newer_in_flight) {
  if (newer_in_flight) {
    __pipeline_wait_prior(1);
  } else {
    __pipeline_wait_prior(0);
  }
  __syncthreads();
}

}  // namespace csr_stream
