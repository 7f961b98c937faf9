// Fused MoE router for Hopper (sm_90a), paper section III.A.c.
//
// Replaces the Pallas TPU kernel moe_router.moe_router
// (src/repro/kernels/moe_router.py): for each token row of E <= 128 router
// logits, probs = softmax(logits) in float32, then k rounds of "take the
// largest remaining prob, the lowest expert index among equal maxima, and
// mask it to -inf", then gates = the k maxima / max(their sum, 1e-9).
// Outputs: gates (T, k) f32, idx (T, k) int32, probs (T, E) f32.  The
// tie-break is the TPU kernel's min(where(is_max, iota, E)) and is
// reproduced exactly: a row of equal logits gives experts 0..k-1.
//
// What bounds it on the H100: bytes (read T*E*4, write T*E*4 + T*k*8);
// the exp and k compare rounds per value are far below the float rate.
// At the serving shapes (T = 8 decode slots, or one prompt bucket) a call
// moves a few KB to a few MB, so a launch's fixed cost is what the caller
// sees: this first version is simple, one pass, nothing staged.
//
// Design: one warp per token row, 8 rows per 256-thread block, a grid of
// ceil(T / 8) blocks (a ragged tail of rows simply has idle warps: no
// padding).  Lane l holds values l, l + 32, ... of its row in registers
// (NPER = ceil(E / 32) <= 4 of them; lanes past E hold -inf).  The row max
// and the row sum are xor-shuffle butterflies: every lane ends with the
// same value in the same order, so there are no float atomics and the
// result is deterministic.  exp is expf and probs a true division (no
// fast-math: probs and gates are held to 1e-6 of the plain version).  Each
// top-k round reduces (value, index) pairs across the warp under the total
// order "greater value, or equal value and smaller index", so every lane
// agrees on the winner; the lane that holds it masks it.  The k raw gates
// stay in registers (round j in lane j % 32) until their sum is known.
// The TPU kernel does the same on a (block_t, E) VMEM tile with one lane
// tile per row; here a row never leaves one warp's registers.
#include <cuda_runtime.h>
#include <math.h>

namespace repro_torch {

constexpr int MR_THREADS = 256;          // 8 warps: 8 rows per block
constexpr int MR_MAX_PER_LANE = 4;       // E <= 128

template <int NPER>
__global__ void __launch_bounds__(MR_THREADS) moe_router_kernel(
    const float* __restrict__ logits, float* __restrict__ gates,
    int* __restrict__ idx, float* __restrict__ probs, long long T, int E,
    int k) {
  const long long row = (long long)blockIdx.x * (MR_THREADS / 32)
                        + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= T) return;                  // whole warps only: no shuffle hangs
  const float* x = logits + row * E;

  float v[NPER];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < NPER; ++j) {
    const int e = lane + 32 * j;
    v[j] = e < E ? x[e] : -INFINITY;
    m = fmaxf(m, v[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NPER; ++j) {
    const int e = lane + 32 * j;
    v[j] = e < E ? expf(v[j] - m) : 0.f;
    s += v[j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  float* p = probs + row * E;
#pragma unroll
  for (int j = 0; j < NPER; ++j) {
    const int e = lane + 32 * j;
    if (e < E) {
      v[j] = v[j] / s;
      p[e] = v[j];
    } else {
      v[j] = -INFINITY;                  // never wins a round
    }
  }

  float graw[MR_MAX_PER_LANE];
#pragma unroll
  for (int c = 0; c < MR_MAX_PER_LANE; ++c) graw[c] = 0.f;
  int* out_i = idx + row * k;
  float gsum = 0.f;
  for (int r = 0; r < k; ++r) {
    // this lane's best: registers in increasing index order, strict >
    // keeps the lowest index among equals
    float bv = v[0];
    int bi = lane;
#pragma unroll
    for (int j = 1; j < NPER; ++j)
      if (v[j] > bv) {
        bv = v[j];
        bi = lane + 32 * j;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    gsum += bv;                          // rounds in order, as the TPU's
    if (lane == (r & 31)) {
      out_i[r] = bi;
#pragma unroll
      for (int c = 0; c < MR_MAX_PER_LANE; ++c)
        if ((r >> 5) == c) graw[c] = bv;
    }
    if ((bi & 31) == lane) {
#pragma unroll
      for (int j = 0; j < NPER; ++j)
        if ((bi >> 5) == j) v[j] = -INFINITY;
    }
  }
  gsum = fmaxf(gsum, 1e-9f);
  float* out_g = gates + row * k;
#pragma unroll
  for (int c = 0; c < MR_MAX_PER_LANE; ++c) {
    const int r = lane + 32 * c;
    if (r < k) out_g[r] = graw[c] / gsum;
  }
}

}  // namespace repro_torch

// logits (T, E) f32 contiguous -> gates (T, k) f32, idx (T, k) int32,
// probs (T, E) f32; 1 <= k <= E <= 128.
extern "C" int repro_moe_router(const void* logits, void* gates, void* idx,
                                void* probs, long long T, int E, int k,
                                void* stream) {
  using namespace repro_torch;
  if (E < 1 || E > 32 * MR_MAX_PER_LANE || k < 1 || k > E || T < 0)
    return (int)cudaErrorInvalidValue;
  const long long rows_per_block = MR_THREADS / 32;
  const long long blocks = (T + rows_per_block - 1) / rows_per_block;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lg = static_cast<const float*>(logits);
  float* g = static_cast<float*>(gates);
  int* ix = static_cast<int*>(idx);
  float* p = static_cast<float*>(probs);
  const int nper = (E + 31) / 32;
  if (nper == 1)
    moe_router_kernel<1><<<(unsigned)blocks, MR_THREADS, 0, s>>>(
        lg, g, ix, p, T, E, k);
  else if (nper == 2)
    moe_router_kernel<2><<<(unsigned)blocks, MR_THREADS, 0, s>>>(
        lg, g, ix, p, T, E, k);
  else if (nper == 3)
    moe_router_kernel<3><<<(unsigned)blocks, MR_THREADS, 0, s>>>(
        lg, g, ix, p, T, E, k);
  else
    moe_router_kernel<4><<<(unsigned)blocks, MR_THREADS, 0, s>>>(
        lg, g, ix, p, T, E, k);
  return (int)cudaGetLastError();
}
