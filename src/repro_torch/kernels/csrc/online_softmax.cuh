// Shared device code of the attention kernels: element conversion, warp
// reductions, the key/value row sources (dense or paged, 16-bit or int8
// with f32 scales), and one warp's online-softmax pass over a key range.
//
// Layout contract (checked by the Python wrappers): the last dimension of
// every value tensor is contiguous, D is 32, 64 or 128, and every row start
// is 16-byte aligned, so a K row is read with 16-byte vector loads.  Scale
// tensors are read one float at a time through their strides.
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

template <int D>
__device__ __forceinline__ float dot_row(const float* qs,
                                         const __nv_bfloat16* k) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D; i += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(k + i);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(h2[t]);
      s += qs[i + 2 * t] * f.x + qs[i + 2 * t + 1] * f.y;
    }
  }
  return s;
}

// int8 row: 16 values per 16-byte load, widened to float before the FMA
// (the scale is folded in by the caller, after the dot, as on the TPU).
template <int D>
__device__ __forceinline__ float dot_row(const float* qs, const int8_t* k) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D; i += 16) {
    const int4 raw = *reinterpret_cast<const int4*>(k + i);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int t = 0; t < 16; ++t) s += qs[i + t] * static_cast<float>(c[t]);
  }
  return s;
}

// Where the K/V rows of one (slot, KV head) live, and how they are stored.
//
// V is the stored element type: float or bf16 (16-bit layouts, read as
// they are) or int8 (values with one f32 scale per (position, head)).
// Positions are virtual: with PAGED, position p is row p % bs of physical
// block table[p / bs] (the table row sits in shared memory), each tensor
// addressed as block * s0 + row * s1; dense, position p is row p * s1 of a
// base pointer that already includes the slot.  k/v (and ks/vs) include the
// KV head's offset.
template <typename V, bool PAGED>
struct KVRows {
  static constexpr bool kQuant = std::is_same<V, int8_t>::value;
  const V* k;
  const V* v;
  const float* ks;  // int8 only: the K and V scales
  const float* vs;
  long long k0, k1, v0, v1, ks0, ks1, vs0, vs1;
  const int* table;  // PAGED only
  int bs;

  __device__ __forceinline__ long long at(int pos, long long s0,
                                          long long s1) const {
    if constexpr (PAGED)
      return static_cast<long long>(table[pos / bs]) * s0 +
             static_cast<long long>(pos % bs) * s1;
    else
      return static_cast<long long>(pos) * s1;
  }

  // q . k[pos], times k's scale for int8 rows
  template <int D>
  __device__ __forceinline__ float score(const float* qs, int pos) const {
    const float s = dot_row<D>(qs, k + at(pos, k0, k1));
    if constexpr (kQuant) return s * ks[at(pos, ks0, ks1)];
    else return s;
  }

  __device__ __forceinline__ float v_scale(int pos) const {
    if constexpr (kQuant) return vs[at(pos, vs0, vs1)];
    else return 1.f;
  }

  __device__ __forceinline__ const V* v_row(int pos) const {
    return v + at(pos, v0, v1);
  }
};

// One warp's online softmax over keys [lo, hi) for one query row.
//
// The warp takes the keys 32 at a time, one key per lane, starting at
// tile `first` and stepping `stride` tiles (so several warps of a block can
// split one key range).  A lane scores its key against q (qs, D floats in
// shared memory) and scales by `post_scale`; masked keys score NEG_INF and
// get probability 0.  The running sum l takes the probabilities before an
// int8 row's V scale multiplies them (l must not contain v_s).  Each lane
// then owns D/32 consecutive output columns and adds p_j * V[j] for the
// tile's keys, p_j broadcast by shuffle.  (m, l, acc) carry the running
// max, sum and unnormalised output.
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
    if (ok) p *= rows.v_scale(key);
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
  KVRows<T, false> rows{};
  rows.k = kbase;
  rows.v = vbase;
  rows.k1 = k_stride;
  rows.v1 = v_stride;
  warp_attend_rows<D>(qs, post_scale, rows, lo, hi, first, stride, valid, m,
                      l, acc);
}

}  // namespace repro_torch
