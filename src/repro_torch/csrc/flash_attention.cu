// Causal / sliding-window GQA attention with an online softmax, kernel B5.
//
// Replaces the TPU kernel `flash_attention_pallas` (body `_flash_kernel`) in
// src/repro/kernels/flash_attention/kernel.py.  For q [BH, Sq, D] and k, v
// [BKV, Skv, D] (BH % BKV == 0, KV head of q head bh = bh / group) it
// computes, per row,
//
//   s = (q . k) * scale  (f32, scale = 1/sqrt(D)),  masked to -1e30 where
//       causal and q_pos < k_pos, or window > 0 and q_pos - k_pos >= window
//   o = softmax(s) @ v    (f32 running max m, normaliser l, accumulator)
//
// and writes o in the input type (f32 or bf16, rounded to nearest).
//
// What bounds it on an H100: operations.  At the prefill shape (B=2, H=24,
// KVH=8, S=4096, D=128, causal) the work is 4*B*H*D*S(S+1)/2 = 2.06e11
// flops against 134 MB of q, k, v and o: 0.209 ms at the tensor cores'
// 989 TFLOP/s, 40 us at 3.35 TB/s.  This first form runs on the CUDA cores
// in f32 (67 TFLOP/s peak), so it cannot come near that bound; wgmma, TMA
// and warp specialisation are later work.  What the design does about the
// CUDA-core rate: each thread keeps a 4-row register tile of the logits and
// of the output accumulator and reads its operands from shared memory as
// float4, two to four FMAs per shared-memory byte, with row strides padded
// by four floats so that a warp's float4 reads take the fewest wavefronts.
//
// Schedule.  One block per (q tile of 64 rows, bh); the Pallas grid's
// sequential KV axis becomes a loop inside the block over KV tiles of 32
// keys, staged in dynamic shared memory as f32 (above 48 KB opted into).
// The KV head is read in place as bh / group, never copied per q head.
// KV tiles that are masked for every row of the q tile are skipped, which
// is exact: a skipped tile before a row's first live key only adds p = 1
// terms that the first live tile scales by exp(-1e30 - m) = 0, and one
// after its last live key adds p = exp(-1e30 - m) = 0.  A row with no live
// key at all (window > 0 and q_pos >= Skv + window - 1) gets p = 1 on every
// key, and so the mean of v, as the Pallas kernel and `attention_ref` give
// it; a q tile holding such a row therefore runs every KV tile.  Blocks of
// the longest causal rows are scheduled first.
//
// Precision: expf (never __expf; nvcc runs without --use_fast_math), f32
// sums, one correctly rounded division by max(l, 1e-30) at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kTileQ = 64;
constexpr int kTileKV = 32;
constexpr int kRowsPerThread = kTileQ / 16;
constexpr int kColsPerThread = kTileKV / 16;
constexpr int kLdP = kTileKV + 4;
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// `rows` contiguous rows of length d from global memory into a shared f32
// tile with row stride ld; columns >= d are left as they are (zero).
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int d,
                                      int rows, float* __restrict__ dst,
                                      int ld) {
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d;
    dst[r * ld + (i - r * d)] = to_f32(src[i]);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float half_warp_max(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((kTileQ + 2 * kTileKV) * (DMAX + 4) + kTileQ * kLdP);
}

// DMAX: the head dim rounded up to 64, 128 or 256; d <= DMAX at run time.
template <int DMAX, typename T>
__global__ void __launch_bounds__(kThreads, DMAX > 128 ? 1 : 2)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int s_q, int s_kv,
              int d, int group, float scale, int causal, int window) {
  constexpr int kLd = DMAX + 4;          // row stride of the f32 tiles
  constexpr int kGroups = DMAX / 64;     // float4 output groups per thread
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + kTileQ * kLd;
  float* sv = sk + kTileKV * kLd;
  float* sp = sv + kTileKV * kLd;

  const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int bh = blockIdx.y;
  const int q_lo = q_tile * kTileQ;
  const int q_hi = q_lo + kTileQ - 1;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int row0 = ty * kRowsPerThread;

  const T* kb = k + static_cast<size_t>(bh / group) * s_kv * d;
  const T* vb = v + static_cast<size_t>(bh / group) * s_kv * d;

  // zero q, k and v tiles once: staging writes only columns < d, and the
  // products read whole float4 groups up to DMAX
  for (int i = threadIdx.x; i < (kTileQ + 2 * kTileKV) * kLd; i += kThreads)
    sq[i] = 0.f;
  __syncthreads();
  stage(q + (static_cast<size_t>(bh) * s_q + q_lo) * d, d, kTileQ, sq, kLd);

  float m[kRowsPerThread], l[kRowsPerThread];
  float acc[kRowsPerThread][4 * kGroups];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kGroups; ++c) acc[i][c] = 0.f;
  }

  const int n_kv = s_kv / kTileKV;
  int kv_begin = 0;
  int kv_end = n_kv;
  const bool dead_row = window > 0 && q_hi >= s_kv + window - 1;
  if (!dead_row) {
    if (causal) kv_end = min(n_kv, q_hi / kTileKV + 1);
    if (window > 0) kv_begin = max(0, q_lo - window + 1) / kTileKV;
  }

  for (int t = kv_begin; t < kv_end; ++t) {
    const int k_lo = t * kTileKV;
    __syncthreads();  // the last tile's readers are done; q is staged
    stage(kb + static_cast<size_t>(k_lo) * d, d, kTileKV, sk, kLd);
    stage(vb + static_cast<size_t>(k_lo) * d, d, kTileKV, sv, kLd);
    __syncthreads();

    // logits of rows row0 + i and columns tx + 16 j
    float s[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; c += 4) {
      float4 qv[kRowsPerThread], kv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = ld4(sq + (row0 + i) * kLd + c);
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        kv[j] = ld4(sk + (tx + 16 * j) * kLd + c);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // online softmax; the 16 threads of a half warp share rows row0 + i
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int q_pos = q_lo + row0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int k_pos = k_lo + tx + 16 * j;
        const bool live = (!causal || q_pos >= k_pos) &&
                          (window <= 0 || q_pos - k_pos < window);
        s[i][j] = live ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float p = expf(s[i][j] - m_new);
        sp[(row0 + i) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kGroups; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // p rows row0.. were written by this half warp

    // acc += p @ v over the tile; columns tx * 4 + 64 g + e
    for (int kk = 0; kk < kTileKV; kk += 4) {
      float4 pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = ld4(sp + (row0 + i) * kLdP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 vv[kGroups];
#pragma unroll
        for (int g = 0; g < kGroups; ++g)
          vv[g] = ld4(sv + (kk + u) * kLd + tx * 4 + 64 * g);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float p = u == 0 ? pv[i].x
                        : u == 1 ? pv[i].y
                        : u == 2 ? pv[i].z
                                 : pv[i].w;
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
            acc[i][4 * g + 0] = fmaf(p, vv[g].x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(p, vv[g].y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(p, vv[g].z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(p, vv[g].w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const float norm = fmaxf(l[i], 1e-30f);
    T* orow = o + (static_cast<size_t>(bh) * s_q + q_lo + row0 + i) * d;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = tx * 4 + 64 * g + e;
        if (col < d) orow[col] = from_f32<T>(acc[i][4 * g + e] / norm);
      }
  }
}

template <int DMAX, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int s_q, int s_kv, int d, int group, float scale,
                   int causal, int window, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<DMAX, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(s_q / kTileQ, bh);
  flash_fwd<DMAX, T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s_q, s_kv, d, group,
      scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int bh, int s_q, int s_kv, int d, int group, float scale,
                     int causal, int window, cudaStream_t stream) {
  if (d <= 64)
    return launch<64, T>(q, k, v, o, bh, s_q, s_kv, d, group, scale, causal,
                         window, stream);
  if (d <= 128)
    return launch<128, T>(q, k, v, o, bh, s_q, s_kv, d, group, scale, causal,
                          window, stream);
  return launch<256, T>(q, k, v, o, bh, s_q, s_kv, d, group, scale, causal,
                        window, stream);
}

}  // namespace

// q [bh, s_q, d], k and v [bh / group, s_kv, d], o [bh, s_q, d], contiguous,
// f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); s_q % 64 == 0, s_kv % 32 == 0,
// 1 <= d <= 256.  Launches on `stream`; returns the cudaError_t of the
// launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bh, int s_q,
                                      int s_kv, int d, int group, float scale,
                                      int causal, int window, int is_bf16,
                                      cudaStream_t stream) {
  if (d < 1 || d > 256 || group < 1 || bh % group != 0 ||
      s_q % kTileQ != 0 || s_kv % kTileKV != 0 || bh > 65535)
    return cudaErrorInvalidValue;
  if (bh == 0 || s_q == 0) return cudaSuccess;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, bh, s_q, s_kv, d, group,
                                   scale, causal, window, stream);
  return dispatch<float>(q, k, v, o, bh, s_q, s_kv, d, group, scale, causal,
                         window, stream);
}
