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
// 989 TFLOP/s, 40 us at 3.35 TB/s.
//
// Two kernels, picked by the wrapper from the input type and head dim
// (kernels/flash_attention/kernel.tile_plan):
//
// flash_fwd_tc, bf16 with D % 8 == 0 and D <= 256: the tensor cores.
//   One block of three warpgroups per (q tile of 128 rows, bh).  Warpgroup 0
//   is the producer: one thread loads the q tile once and then K and V tiles
//   of BN keys (64, or 32 past D = 192, so that the registers below fit)
//   by TMA into a ring of three stages in
//   dynamic shared memory, from 3-D tensor maps over [B*H, S, D] and
//   [B*KVH, S, D], so that q head bh reads KV head bh / group in place.
//   Each stage has an mbarrier that the TMA completes (full) and one that
//   the 256 consumer threads arrive on once they are done with it (empty).
//   Warpgroups 1 and 2 are the consumers, each owning 64 q rows; setmaxnreg
//   moves registers from the producer (24) to them (240), though ptxas
//   allocated at most 176 in the consumer code (SASS of D = 128, 256).  The
//   two consumers run unsynchronised: passing the turn to issue wgmma
//   between them (ping-pong, two named barriers) measured 1.097 ms against
//   0.915 ms without at the main shape on an H100 80GB HBM3 at 700 W, and
//   spilled.  Tiles sit in the 128-byte swizzle that the wgmma
//   shared-memory descriptors name: a row of 64 bf16 is one 128-byte line,
//   so a D = 128 row is two such column regions (D = 120 is padded to 128
//   by the box's zero fill).  Per KV tile a consumer runs
//     s = q . k^T   wgmma m64nBNk16, bf16 x bf16 into f32, both operands
//                   K-major in shared memory; a product of two bf16 values
//                   is exact in f32, so this differs from an f32 dot only
//                   in the order of the sum;
//     mask and online softmax on the accumulator registers (a thread holds
//                   two rows; row max over the 4 lanes that share a row),
//                   in the log2 domain: ex2.approx of s * scale * log2(e)
//                   - m, one MUFU op;
//     o += p . v    as three bf16 terms, p = p_hi + p_mid + p_lo, each the
//                   bf16 rounding of what the terms before it leave: each a
//                   wgmma m64nDk16 with A from registers (the accumulator
//                   layout of s is the A fragment layout of p) and V
//                   MN-major in shared memory.  One bf16 term (what SDPA
//                   does) errs by up to 2^-8 of p, two by 2^-17, three
//                   carry f32's 24 bits exactly (p >= 2^-100).  Two terms
//                   missed the one-bf16-step check by up to 2e-6 where an
//                   output cancels near zero.
//                   Up to D = 128 the products go to a zeroed f32 tile and
//                   then into the accumulator on the CUDA cores (promote,
//                   below); past it straight into the accumulator.  With
//                   three terms, the excess over one bf16 step (chip_smoke
//                   check_flash, limit 1e-6) measured 1.04e-7 at the
//                   minitron-4b shape, 1.19e-7 at h2o-danube's (D = 120,
//                   window 4096), 8.94e-8 at stablelm's (D = 64) and
//                   5.96e-8 where Sq > Skv + window (H100 80GB HBM3).
//   The final division by max(l, 1e-30) is in f32.
//
// flash_fwd, f32 (and bf16 with D % 8 != 0, whose rows TMA cannot address):
//   the CUDA cores in f32 (67 TFLOP/s peak).  Single-pass TF32 on the
//   tensor cores cannot meet the f32 contract (2e-5 against f32 math); a
//   3xTF32 path is later work.  Each thread keeps a 4-row register tile of
//   the logits and of the output accumulator and reads its operands from
//   shared memory as float4, two to four FMAs per shared-memory byte, with
//   row strides padded by four floats so that a warp's float4 reads take the
//   fewest wavefronts.  One block per (q tile of 64 rows, bh); the Pallas
//   grid's sequential KV axis becomes a loop inside the block over KV tiles
//   of 32 keys, staged in dynamic shared memory as f32.
//
// Both kernels skip KV tiles that are masked for every row of the q tile,
// which is exact: a skipped tile before a row's first live key only adds
// p = 1 terms that the first live tile scales by exp(-1e30 - m) = 0, and one
// after its last live key adds p = exp(-1e30 - m) = 0.  A row with no live
// key at all (window > 0 and q_pos >= Skv + window - 1) gets p = 1 on every
// key, and so the mean of v, as the Pallas kernel and `attention_ref` give
// it; a q tile holding such a row therefore runs every KV tile.  Blocks of
// the longest causal rows are scheduled first.
//
// Precision: f32 sums, one correctly rounded division by max(l, 1e-30) at
// the end; the CUDA-core kernel uses expf (never __expf; nvcc runs without
// --use_fast_math).  The tensor maps are encoded through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda.h>  // CUtensorMap and its enums; no driver call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// ---------------------------------------------------------------------------
// flash_fwd_tc: bf16 on the tensor cores (wgmma, TMA, warp specialisation)

namespace tc {

constexpr int kThreads = 384;  // the producer warpgroup and two consumers
constexpr int kTileQ = 128;    // q rows a block; 64 a consumer warpgroup
constexpr int kStages = 3;     // K+V stages in the ring
constexpr int kRegion = 64;    // bf16 columns in one 128-byte swizzle line
constexpr int kLine = 128;     // bytes of one swizzled row
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kTerms = 3;      // bf16 terms of p in p . v

// Whether a tile's p . v goes to a zeroed f32 tile first and then into the
// accumulator on the CUDA cores (acc = acc * corr + tile, rounded to
// nearest), or straight into the accumulator.  The tensor cores' f32 sums
// lose more than a rounding a step: with 768 steps into one accumulator
// (S = 4096, three terms) the straight form's excess over one bf16 step
// reached 9.6e-7, at the edge of chip_smoke.py's 1e-6; the tile sums cut
// it to 1.5e-7.  The tile is one 64-column region of o at a time (32
// registers); past DP = 128 the accumulator leaves no room.
template <int DP>
__host__ __device__ constexpr bool promote() {
  return DP <= 128;
}

// The KV tile for a padded head dim: a consumer thread holds DP / 2 floats
// of the 64 x DP accumulator (twice that with promote), BN / 2 of s and
// 3 BN / 4 registers of p's bf16 terms, within the 240 registers setmaxnreg
// gives it.
template <int DP>
__host__ __device__ constexpr int kv_tile() {
  return DP <= 192 ? 64 : 32;
}

template <int DP>
constexpr size_t smem_bytes() {
  // q, then kStages of (K, V), then the barriers; 1024 for the alignment
  // the swizzle atoms need
  return static_cast<size_t>(DP / kRegion) * kLine *
             (kTileQ + 2 * kStages * kv_tile<DP>()) +
         8 * (1 + 2 * kStages) + 1024;
}

// exp2 as one MUFU op; a result below 2^-126 flushes to zero
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}


__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the barrier's phase of `parity` has completed.  A wait that
// lasts ten seconds traps (a launch error) rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  unsigned long long since = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const unsigned long long now = global_ns();
    if (since == 0) {
      since = now;
    } else if (now - since > 10000000000ull) {
      __trap();
    }
  }
}

// One box of a 3-D tensor map (c0 the column, c1 the row, c2 the head)
// into shared memory; completes `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptors for the 128-byte swizzle (layout type 1
// in bits 62-63); addresses and offsets in 16-byte units.  K-major (q and
// K): rows of one 128-byte line, 8-row groups 1024 bytes apart.  MN-major
// (V as the B operand of p . v): 64-column regions `region` bytes apart,
// 8-key groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_field(uint32_t x) {
  return (x & 0x3FFFF) >> 4;
}

__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return desc_field(addr) | desc_field(16) << 16 | desc_field(1024) << 32 |
         1ull << 62;
}

__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr,
                                                  uint32_t region) {
  return desc_field(addr) | desc_field(region) << 16 |
         desc_field(1024) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accumulator registers across the
// asynchronous wgmma instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// d (+)= a . b over k = 16, m64n32k16: a and b K-major in shared memory,
// d zeroed first unless `accumulate`
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= a . b over k = 16, m64n64k16: a and b K-major in shared memory,
// d zeroed first unless `accumulate`
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= a . b over k = 16, m64n64k16: a in registers, b MN-major in
// shared memory, d zeroed first unless `accumulate`
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d (+)= a . b over k = 16, m64n192k16: a in registers, b MN-major in
// shared memory, d zeroed first unless `accumulate`
__device__ __forceinline__ void mma_rs_n192(float (&d)[96],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d (+)= a . b over k = 16, m64n256k16: a in registers, b MN-major in
// shared memory, d zeroed first unless `accumulate`
__device__ __forceinline__ void mma_rs_n256(float (&d)[128],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b, int accumulate) {
  static_assert(N == 32 || N == 64, "s tiles are 32 or 64 keys wide");
  if constexpr (N == 32) {
    mma_ss_n32(d, a, b, accumulate);
  } else {
    mma_ss_n64(d, a, b, accumulate);
  }
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b,
                                       int accumulate) {
  static_assert(N == 64 || N == 192 || N == 256,
                "o is a 64-column region, or the whole row past D = 128");
  if constexpr (N == 64) {
    mma_rs_n64(d, a, b, accumulate);
  } else if constexpr (N == 192) {
    mma_rs_n192(d, a, b, accumulate);
  } else {
    mma_rs_n256(d, a, b, accumulate);
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// DP: the head dim padded to a multiple of 64 (64, 128, 192 or 256).
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 __nv_bfloat16* __restrict__ o, int s_q, int s_kv, int d,
                 int group, float scale_log2, int causal, int window) {
  constexpr int BN = kv_tile<DP>();
  constexpr int R = DP / kRegion;  // 128-byte column regions of a row
  constexpr uint32_t kQRegion = kTileQ * kLine;
  constexpr uint32_t kKVRegion = BN * kLine;
  constexpr uint32_t kQBytes = R * kQRegion;
  constexpr uint32_t kStageBytes = 2 * R * kKVRegion;  // K, then V
  extern __shared__ unsigned char smem_raw[];
  // swizzle atoms are 1024-byte aligned
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kQBytes + kStages * kStageBytes;
  const uint32_t bar_q = bars;
  auto bar_full = [&](int s) { return bars + 8u * (1 + s); };
  auto bar_empty = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto stage_k = [&](int s) { return base + kQBytes + s * kStageBytes; };

  const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int bh = blockIdx.y;
  const int q_lo = q_tile * kTileQ;
  const int q_hi = q_lo + kTileQ - 1;
  const int n_kv = s_kv / BN;
  int kv_begin = 0;
  int kv_end = n_kv;
  const bool dead_row = window > 0 && q_hi >= s_kv + window - 1;
  if (!dead_row) {
    if (causal) kv_end = min(n_kv, q_hi / BN + 1);
    if (window > 0) kv_begin = max(0, q_lo - window + 1) / BN;
  }
  const int n_tiles = kv_end - kv_begin;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // the producer: one thread issues every TMA load of the block
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, kQBytes);
      for (int r = 0; r < R; ++r) {
        tma_load(base + r * kQRegion, &map_q, bar_q, r * kRegion, q_lo, bh);
      }
      const int kvh = bh / group;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(bar_empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full(s), kStageBytes);
        const int k_lo = (kv_begin + i) * BN;
        const uint32_t sk = stage_k(s);
        for (int r = 0; r < R; ++r) {
          tma_load(sk + r * kKVRegion, &map_k, bar_full(s), r * kRegion,
                   k_lo, kvh);
          tma_load(sk + (R + r) * kKVRegion, &map_v, bar_full(s),
                   r * kRegion, k_lo, kvh);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 q rows; a thread holds rows row0 and row0 + 8
  // and, of each 8 columns of a tile, columns 2 qd and 2 qd + 1
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int qd = lane % 4;
  const int row_lo = q_lo + 64 * c;
  const int row0 = row_lo + 16 * (t / 32) + lane / 4;
  const uint32_t q_base = base + 64u * c * kLine;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's columns only, until the end
  mbar_wait(bar_q, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int k_lo = (kv_begin + i) * BN;
    mbar_wait(bar_full(s), (i / kStages) & 1);
    const uint32_t sk = stage_k(s);
    const uint32_t sv = sk + R * kKVRegion;

    // s = q . k^T over the padded head dim, 16 columns a step
    float sc[BN / 2];
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32u;  // bytes into the 128-byte row
      mma_ss<BN>(sc, desc_k_major(q_base + (kk / 4) * kQRegion + col),
                 desc_k_major(sk + (kk / 4) * kKVRegion + col), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // mask (only where some entry of the tile may be masked) and scale
    const bool all_live =
        (!causal || row_lo >= k_lo + BN - 1) &&
        (window <= 0 || row_lo + 63 - k_lo < window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * scale_log2;
        if (!all_live) {
          const int q_pos = row0 + 8 * (e >> 1);
          const int k_pos = k_lo + 8 * j + 2 * qd + (e & 1);
          const bool live = (!causal || q_pos >= k_pos) &&
                            (window <= 0 || q_pos - k_pos < window);
          x = live ? x : kNegInf;
        }
        sc[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    // online softmax; the 4 lanes of a row reduce its max
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = fast_exp2(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(sc[4 * j + e] - m[e >> 1]);
        sc[4 * j + e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
    if constexpr (!promote<DP>()) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
    }

    // p = p_hi + p_mid + p_lo, each the bf16 rounding of what the terms
    // before it leave, laid out as wgmma A fragments: the accumulator's
    // columns 16 kk .. 16 kk + 15 are A's k-step kk
    uint32_t pa[kTerms][BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float a = sc[8 * kk + 2 * r];
        float b = sc[8 * kk + 2 * r + 1];
#pragma unroll
        for (int term = 0; term < kTerms; ++term) {
          const __nv_bfloat162 t2 = __floats2bfloat162_rn(a, b);
          pa[term][kk][r] = bits(t2);
          const float2 back = __bfloat1622float2(t2);
          a -= back.x;
          b -= back.y;
        }
      }
    }

    // acc += p_hi . v + p_mid . v + p_lo . v, 16 keys a step
#pragma unroll
    for (int term = 0; term < kTerms; ++term) fence_regs(pa[term]);
    if constexpr (promote<DP>()) {
      // one 64-column region of o at a time into a zeroed f32 tile, then
      // acc = acc * corr + tile on the CUDA cores
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float tile[32];
        fence_regs(tile);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          const uint64_t b = desc_mn_major(
              sv + r * kKVRegion + kk * 16u * kLine, kKVRegion);
#pragma unroll
          for (int term = 0; term < kTerms; ++term) {
            mma_rs<64>(tile, pa[term][kk], b, kk > 0 || term > 0);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(tile);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          acc[32 * r + i] =
              fmaf(acc[32 * r + i], corr[(i >> 1) & 1], tile[i]);
        }
      }
    } else {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t b = desc_mn_major(sv + kk * 16u * kLine, kKVRegion);
#pragma unroll
        for (int term = 0; term < kTerms; ++term) {
          mma_rs<DP>(acc, pa[term][kk], b, 1);
        }
      }
      wgmma_commit();
        wgmma_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(bar_empty(s));
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float norm = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow =
        o + (static_cast<size_t>(bh) * s_q + row0 + 8 * h) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * qd;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] / norm,
                                  acc[4 * j + 2 * h + 1] / norm);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A [heads, rows, d] bf16 tensor, boxes of 64 columns x box_rows rows of
// one head, 128-byte swizzle; columns past d read as zero.
bool encode(CUtensorMap* map, const void* ptr, int heads, int rows, int d,
            int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {kRegion, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int s_q, int s_kv, int d, int group, float scale,
                   int causal, int window, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  CUtensorMap map_q, map_k, map_v;
  if (!encode(&map_q, q, bh, s_q, d, kTileQ) ||
      !encode(&map_k, k, bh / group, s_kv, d, kv_tile<DP>()) ||
      !encode(&map_v, v, bh / group, s_kv, d, kv_tile<DP>())) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(s_q / kTileQ, bh);
  flash_fwd_tc<DP><<<grid, kThreads, bytes, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), s_q, s_kv, d,
      group, scale * kLog2e, causal, window);
  return cudaGetLastError();
}

}  // namespace tc

// The tensor-core kernel: q [bh, s_q, d], k and v [bh / group, s_kv, d],
// o [bh, s_q, d], contiguous bf16, each 16-byte aligned; d % 8 == 0, d_pad
// the multiple of 64 that d rounds up to (<= 256) and kv_tile the KV tile
// of that d_pad (64, or 32 past 192), both as the wrapper's tile plan gives
// them; s_q % 128 == 0, s_kv % kv_tile == 0.  Launches on `stream`;
// returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* o, int bh,
                                         int s_q, int s_kv, int d, int d_pad,
                                         int kv_tile, int group, float scale,
                                         int causal, int window,
                                         cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (d < 8 || d % 8 != 0 || d_pad != (d + 63) / 64 * 64 || d_pad > 256 ||
      kv_tile != (d_pad <= 192 ? 64 : 32) ||
      group < 1 || bh % group != 0 ||
      s_q % tc::kTileQ != 0 || s_kv % kv_tile != 0 || bh > 65535 ||
      !aligned(q) || !aligned(k) || !aligned(v) || !aligned(o)) {
    return cudaErrorInvalidValue;
  }
  if (bh == 0 || s_q == 0) return cudaSuccess;
  switch (d_pad) {
    case 64:
      return tc::launch<64>(q, k, v, o, bh, s_q, s_kv, d, group, scale,
                            causal, window, stream);
    case 128:
      return tc::launch<128>(q, k, v, o, bh, s_q, s_kv, d, group, scale,
                             causal, window, stream);
    case 192:
      return tc::launch<192>(q, k, v, o, bh, s_q, s_kv, d, group, scale,
                             causal, window, stream);
    default:
      return tc::launch<256>(q, k, v, o, bh, s_q, s_kv, d, group, scale,
                             causal, window, stream);
  }
}
