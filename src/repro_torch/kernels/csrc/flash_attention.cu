// Prefill flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention.flash_attention
// (src/repro/kernels/flash_attention.py): blocked online-softmax attention,
// forward only, causal and/or sliding-window mask, GQA (query head h reads
// KV head h / G; K/V are never repeated).
//
// What bounds it on the H100: at serving prompt lengths (tens to a few
// hundred tokens, head_dim 64) the work is tiny -- a 200-token causal head
// is ~5 MFLOP over ~100 KB -- so the launch and the latency of the first
// loads dominate; at long prompts it would be the matmul rate, which this
// kernel does not reach (scalar FMAs, no tensor cores).
//
// Design, and where it departs from the TPU kernel's structure:
// * No sequential grid carry.  The TPU grid walks KV blocks as its innermost
//   "arbitrary" dimension and carries (m, l, acc) in VMEM scratch between
//   grid steps.  CUDA blocks run in no order, so here one warp owns one
//   query row and loops over that row's whole key range itself, keeping
//   (m, l, acc) in registers.  Grid: (ceil(Sq / 8), H, B), 8 warps a block.
// * The key loop stops at the row's causal / window limit: keys [lo, hi)
//   with hi = min(row + 1, Sk) when causal, lo = row - window + 1 when
//   windowed.  Inside that range every key passes the TPU kernel's mask
//   (pos_k < kv_len, pos_k <= pos_q, pos_k > pos_q - window), so no key is
//   masked and no key outside it is read.
// * Any Sq / Sk, no padding: rows past Sq exit, keys past Sk are never in
//   range.  The wrapper hands in the strides of q, k, v and o, so the
//   model's (B, S, H, D) tensors are read in place, without a transpose.
// * q is scaled before QK, as on the TPU; scores, softmax and the output
//   accumulate in float32 for f32 and bf16 inputs alike.
// * A row with no key in range writes exact zeros (l floored at 1e-30),
//   the TPU kernel's result for a fully masked row.
#include "online_softmax.cuh"

namespace repro_torch {

constexpr int FA_ROWS = 8;  // query rows (warps) per block

template <typename T, int D>
__global__ void __launch_bounds__(FA_ROWS * 32) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int H, int Hk, int Sq, int Sk, long long sqb,
    long long sqh, long long sqs, long long skb, long long skh, long long sks,
    long long svb, long long svh, long long svs, long long sob, long long soh,
    long long sos, float scale, int causal, int window) {
  constexpr int EPL = D / 32;
  __shared__ float qs[FA_ROWS][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * FA_ROWS + warp;
  if (row >= Sq) return;  // no block-wide barrier below: safe to leave
  const int hk = h / (H / Hk);

  const T* qrow = q + b * sqb + h * sqh + row * sqs;
  for (int d = lane; d < D; d += 32) qs[warp][d] = to_float(qrow[d]) * scale;
  __syncwarp();

  const int hi = causal ? min(row + 1, Sk) : Sk;
  const int lo = window > 0 ? max(row - window + 1, 0) : 0;
  float m = NEG_INF, l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  warp_attend<T, D>(qs[warp], 1.f, k + b * skb + hk * skh,
                    v + b * svb + hk * svh, sks, svs, lo, hi, 0, 1,
                    [](int) { return true; }, m, l, acc);

  const float denom = fmaxf(l, 1e-30f);
  T* orow = o + b * sob + h * soh + row * sos + lane * EPL;
#pragma unroll
  for (int e = 0; e < EPL; ++e) orow[e] = from_float<T>(acc[e] / denom);
}

template <typename T>
static void launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hk, int Sq, int Sk, int D,
                   const long long* st, float scale, int causal, int window,
                   cudaStream_t stream) {
  const dim3 grid((Sq + FA_ROWS - 1) / FA_ROWS, H, B);
#define REPRO_FA_LAUNCH(DD)                                                  \
  flash_attention_kernel<T, DD><<<grid, FA_ROWS * 32, 0, stream>>>(          \
      static_cast<const T*>(q), static_cast<const T*>(k),                    \
      static_cast<const T*>(v), static_cast<T*>(o), H, Hk, Sq, Sk, st[0],    \
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], \
      st[11], scale, causal, window)
  switch (D) {
    case 32: REPRO_FA_LAUNCH(32); break;
    case 64: REPRO_FA_LAUNCH(64); break;
    case 128: REPRO_FA_LAUNCH(128); break;
  }
#undef REPRO_FA_LAUNCH
}

}  // namespace repro_torch

// q (B, H, Sq, D), k/v (B, Hk, Sk, D), o like q, each given by its
// (batch, head, position) strides in elements.  Returns cudaGetLastError().
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int is_bf16, int B,
    int H, int Hk, int Sq, int Sk, int D, long long sqb, long long sqh,
    long long sqs, long long skb, long long skh, long long sks, long long svb,
    long long svh, long long svs, long long sob, long long soh, long long sos,
    float scale, int causal, int window, void* stream) {
  if (D != 32 && D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  const long long st[12] = {sqb, sqh, sqs, skb, skh, sks,
                            svb, svh, svs, sob, soh, sos};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    repro_torch::launch<__nv_bfloat16>(q, k, v, o, B, H, Hk, Sq, Sk, D, st,
                                       scale, causal, window, s);
  else
    repro_torch::launch<float>(q, k, v, o, B, H, Hk, Sq, Sk, D, st, scale,
                               causal, window, s);
  return (int)cudaGetLastError();
}
