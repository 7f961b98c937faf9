// Block-local top-k gradient sparsification for Hopper (sm_90a), paper
// Eq. 11.
//
// Replaces the Pallas TPU kernel topk_sparsify.topk_sparsify
// (src/repro/kernels/topk_sparsify.py): for each row of `block` values, k
// rounds of "m = max of the masked magnitudes, then mask every magnitude
// >= m to -1"; the last round's m is the threshold t, kept = x where
// |x| >= t (else 0), resid = x - kept.  The threshold is therefore the k-th
// largest *distinct* magnitude, and when a row has fewer than k distinct
// magnitudes the rounds run into the -1 sentinel and keep the whole row --
// the TPU kernel's semantics, which this kernel follows exactly (not the
// sort of kernels/ref.py, which counts repeated magnitudes).
//
// What bounds it on the H100: by the roofline, bytes (read 4 bytes, write
// 8 per element; k compares per element are far below the float rate).  In
// practice the k block-wide reductions, each ending in a barrier, make it
// latency-bound: this first version is simple, not fast.
//
// Design: one CUDA block of 256 threads per row.  Thread t reads elements
// t, t + 256, ... of its row once and keeps them in registers (up to 16 a
// thread, so rows of up to 4096 values; the wrapper checks).  In the pass
// that masks them for round r it also takes their maximum for round r + 1;
// one warp-shuffle max and one 8-word shared-memory max per round give the
// block's maximum.
// Max is exact whatever the order, so kept and resid equal the plain
// version bit for bit.  The TPU kernel's row lives in VMEM and loops k times
// over it on the vector unit; here it never leaves registers.
#include <cuda_runtime.h>
#include <math.h>

namespace repro_torch {

constexpr int TK_THREADS = 256;
constexpr int TK_PER_THREAD = 16;   // rows of up to 4096 values

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < TK_THREADS / 32; ++w) m = fmaxf(m, red[w]);
  __syncthreads();   // red is rewritten by the next round
  return m;
}

__global__ void __launch_bounds__(TK_THREADS) topk_sparsify_kernel(
    const float* __restrict__ x, float* __restrict__ kept,
    float* __restrict__ resid, int block, int k) {
  __shared__ float red[TK_THREADS / 32];
  const long long base = (long long)blockIdx.x * block;
  float xs[TK_PER_THREAD], a[TK_PER_THREAD];
  float local = -1.f;   // below every magnitude, like the sentinel
#pragma unroll
  for (int e = 0; e < TK_PER_THREAD; ++e) {
    const int i = threadIdx.x + e * TK_THREADS;
    xs[e] = i < block ? x[base + i] : 0.f;
    a[e] = i < block ? fabsf(xs[e]) : -1.f;
    local = fmaxf(local, a[e]);
  }
  float t = INFINITY;   // k == 0 keeps nothing, as the TPU kernel's init
  for (int r = 0; r < k; ++r) {
    const float m = block_max(local, red);
    local = -1.f;
#pragma unroll
    for (int e = 0; e < TK_PER_THREAD; ++e) {
      if (a[e] >= m) a[e] = -1.f;
      local = fmaxf(local, a[e]);
    }
    t = m;
  }
#pragma unroll
  for (int e = 0; e < TK_PER_THREAD; ++e) {
    const int i = threadIdx.x + e * TK_THREADS;
    if (i < block) {
      const float kv = fabsf(xs[e]) >= t ? xs[e] : 0.f;
      kept[base + i] = kv;
      resid[base + i] = xs[e] - kv;
    }
  }
}

}  // namespace repro_torch

// x (nb, block) f32 contiguous -> kept, resid (nb, block) f32.
extern "C" int repro_topk_sparsify(const void* x, void* kept, void* resid,
                                   long long nb, int block, int k,
                                   void* stream) {
  if (block <= 0 || block > repro_torch::TK_THREADS * repro_torch::TK_PER_THREAD
      || k < 0 || nb > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (nb > 0)
    repro_torch::topk_sparsify_kernel<<<
        (unsigned)nb, repro_torch::TK_THREADS, 0,
        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(kept),
        static_cast<float*>(resid), block, k);
  return (int)cudaGetLastError();
}
