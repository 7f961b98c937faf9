// Shared device code of the attention kernels: element conversion, warp
// reductions, and the f32 prefill body's key/value rows and one warp's
// online-softmax pass over a key range.
//
// Layout contract (checked by the Python wrappers): the last dimension of
// every value tensor is contiguous, D is 32, 64 or 128, and every row start
// is 16-byte aligned, so a K row is read with 16-byte vector loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace repro_torch {

// The TPU kernels' "minus infinity": finite, so exp(NEG_INF - NEG_INF) == 1
// on a row that has seen no live key yet; the probability of a masked key
// is set to 0 after the exp, never taken from it.
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL_MASK, x, o);
  return x;
}

// q (in shared memory, float32) . one K row of D elements, 16-byte loads.
template <int D>
__device__ __forceinline__ float dot_row(const float* qs, const float* k) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(k + i);
    s += qs[i] * x.x + qs[i + 1] * x.y + qs[i + 2] * x.z + qs[i + 3] * x.w;
  }
  return s;
}

// Where the K/V rows of one (batch, KV head) live: position p is row
// p * k1 of k and p * v1 of v, base pointers that include the batch's and
// the head's offsets.  Rows are float32 (the f32 prefill body's).
template <typename V>
struct KVRows {
  const V* k;
  const V* v;
  long long k1, v1;

  // q . k[pos]
  template <int D>
  __device__ __forceinline__ float score(const float* qs, int pos) const {
    return dot_row<D>(qs, k + static_cast<long long>(pos) * k1);
  }

  __device__ __forceinline__ const V* v_row(int pos) const {
    return v + static_cast<long long>(pos) * v1;
  }
};

// One warp's online softmax over keys [lo, hi) for one query row.
//
// The warp takes the keys 32 at a time, one key per lane, starting at
// tile `first` and stepping `stride` tiles (so several warps of a block can
// split one key range).  A lane scores its key against q (qs, D floats in
// shared memory) and scales by `post_scale`; masked keys score NEG_INF and
// get probability 0.  Each lane then owns D/32 consecutive output columns
// and adds p_j * V[j] for the tile's keys, p_j broadcast by shuffle.
// (m, l, acc) carry the running max, sum and unnormalised output.
template <int D, typename Rows, typename Mask>
__device__ __forceinline__ void warp_attend_rows(
    const float* qs, float post_scale, const Rows& rows, int lo, int hi,
    int first, int stride, Mask valid, float& m, float& l,
    float (&acc)[D / 32]) {
  constexpr int EPL = D / 32;
  const int lane = threadIdx.x & 31;
  for (int t0 = lo + 32 * first; t0 < hi; t0 += 32 * stride) {
    const int key = t0 + lane;
    const bool ok = key < hi && valid(key);
    float s = NEG_INF;
    if (ok) s = rows.template score<D>(qs, key) * post_scale;
    const float m_new = fmaxf(m, warp_max(s));
    float p = ok ? expf(s - m_new) : 0.f;
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(p);
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= corr;
    const int n = min(32, hi - t0);
    int j = 0;
    // VB keys at a time: all VB V-row loads are issued before the first
    // is used, so their latencies overlap instead of adding up
    constexpr int VB = 8;
    for (; j + VB <= n; j += VB) {
      float vv[VB][EPL];
#pragma unroll
      for (int u = 0; u < VB; ++u) {
        const auto* vrow = rows.v_row(t0 + j + u) + lane * EPL;
#pragma unroll
        for (int e = 0; e < EPL; ++e) vv[u][e] = to_float(vrow[e]);
      }
#pragma unroll
      for (int u = 0; u < VB; ++u) {
        const float pj = __shfl_sync(FULL_MASK, p, j + u);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] += pj * vv[u][e];
      }
    }
    for (; j < n; ++j) {
      const float pj = __shfl_sync(FULL_MASK, p, j);
      const auto* vrow = rows.v_row(t0 + j) + lane * EPL;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] += pj * to_float(vrow[e]);
    }
    m = m_new;
  }
}

// warp_attend_rows over dense 16-bit rows at fixed strides: kbase/vbase
// point at position 0, k_stride/v_stride step one position.
template <typename T, int D, typename Mask>
__device__ __forceinline__ void warp_attend(
    const float* qs, float post_scale, const T* kbase, const T* vbase,
    long long k_stride, long long v_stride, int lo, int hi, int first,
    int stride, Mask valid, float& m, float& l, float (&acc)[D / 32]) {
  KVRows<T> rows{};
  rows.k = kbase;
  rows.v = vbase;
  rows.k1 = k_stride;
  rows.v1 = v_stride;
  warp_attend_rows<D>(qs, post_scale, rows, lo, hi, first, stride, valid, m,
                      l, acc);
}

}  // namespace repro_torch
