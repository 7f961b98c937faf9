// Length-aware GQA flash-decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel decode_attention.flash_decode_attention
// (src/repro/kernels/decode_attention.py): one decode step attends each
// slot's query rows against that slot's live KV prefix only, with the full,
// sliding-window and ring masks, k-row speculative verify through q_lens,
// and exact zeros for empty slots and dead rows.
//
// What bounds it on the H100: memory.  A step reads every live K/V byte
// once (2 * live * Hk * D * 2 bytes per slot in bf16) and does ~4 FLOP per
// byte, far below the ~295 FLOP/byte at which the tensor cores would bind.
// The design reads only live keys and splits each slot's range over the
// block's warps so several loads are in flight per (slot, KV head).
//
// Design, and where it departs from the TPU kernel's structure:
// * No sequential grid carry.  The TPU grid is (B, Hk, S / block_k) with
//   the KV axis innermost, clamps dead blocks onto the last live one in
//   its index maps, and carries (m, l, acc) across grid steps in VMEM.
//   Here one block per (KV head, slot) loops over the live range inside
//   the block: grid (Hk, B), 4 warps, warp w takes keys
//   [lo + 32 (w + 4 i), ...).  Each warp keeps its own (m, l, acc) and the
//   block merges the four in shared memory at the end.
// * The live range is computed in the block from lengths[b] and q_lens[b],
//   read from device memory (the GPU form of _live_block_bounds, at key
//   rather than block granularity): keys [lo, hi) with
//   hi = min(lengths + q_lens - 1, S) and lo = max(lengths - window, 0)
//   for the linear window band, else 0.  No key outside it is read.
// * Rows are the TPU kernel's folded Sq * G rows (_prep_q): row r is draft
//   j = r / G of query head hk * G + r % G, so query head h reads KV head
//   h / G.  Rows are taken one after another; each re-reads the live K/V
//   (from L2 after the first row).  The serving path has one row per block
//   (Sq = 1, G = 1 for RecLLM), so it reads each live byte once.
// * The cache is read through its strides: a layer's (B, S, Hk, D) view of
//   the stacked (L, B, S, Hk, D) cache is passed as it is.
// * Masks, per row j with eff = lengths + j (the causal intra-draft mask):
//   linear: pos < eff, and pos > eff - 1 - window when windowed; ring:
//   pos < min(eff, S) and floor_mod(eff - 1 - pos, S) < window -- a floor
//   modulo of a value that can be negative, where C++ % truncates; and the
//   draft cap j < q_lens.  A masked key's probability is 0 after the exp,
//   and l is floored at 1e-30, so a row with nothing to attend (len == 0,
//   j >= q_len) writes exact zeros.
// * K/V are read as bf16 or f32; scores, softmax and the output accumulate
//   in float32; the scale multiplies q.k after the dot, as on the TPU.
#include "online_softmax.cuh"

namespace repro_torch {

constexpr int FD_WARPS = 4;

__device__ __forceinline__ int floor_mod(int x, int n) {
  return ((x % n) + n) % n;
}

template <typename T, int D>
__global__ void __launch_bounds__(FD_WARPS * 32) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, const int* __restrict__ lengths,
    const int* __restrict__ q_lens, int Sq, int H, int Hk, int S,
    long long sqb, long long sqj, long long sqh, long long skb, long long sks,
    long long skh, long long svb, long long svs, long long svh, long long sob,
    long long soj, long long soh, float scale, int window, int ring) {
  constexpr int EPL = D / 32;
  __shared__ float qs[D];
  __shared__ float sm_m[FD_WARPS], sm_l[FD_WARPS];
  __shared__ float sm_acc[FD_WARPS][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = H / Hk;
  const int length = lengths[b];
  const int q_len = q_lens != nullptr ? q_lens[b] : Sq;

  const int last = length + q_len - 1;  // the last live row's length
  const int hi = max(min(last, S), 0);
  const int lo = (window > 0 && !ring) ? max(length - window, 0) : 0;
  const T* kb = k + b * skb + hk * skh;
  const T* vb = v + b * svb + hk * svh;

  for (int r = 0; r < Sq * G; ++r) {
    const int j = r / G, h = hk * G + r % G;
    __syncthreads();  // the previous row is done with qs and sm_*
    const T* qrow = q + b * sqb + j * sqj + h * sqh;
    for (int d = threadIdx.x; d < D; d += blockDim.x) qs[d] = to_float(qrow[d]);
    __syncthreads();

    float m = NEG_INF, l = 0.f, acc[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
    if (j < q_len) {
      const int eff = length + j;
      auto valid = [=](int pos) {
        if (ring) return pos < min(eff, S) && floor_mod(eff - 1 - pos, S) < window;
        return pos < eff && (window <= 0 || pos > eff - 1 - window);
      };
      warp_attend<T, D>(qs, scale, kb, vb, sks, svs, lo, hi, warp, FD_WARPS,
                        valid, m, l, acc);
    }
    if (lane == 0) {
      sm_m[warp] = m;
      sm_l[warp] = l;
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][lane * EPL + e] = acc[e];
    __syncthreads();

    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      float mx = NEG_INF;
#pragma unroll
      for (int w = 0; w < FD_WARPS; ++w) mx = fmaxf(mx, sm_m[w]);
      float ls = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < FD_WARPS; ++w) {
        const float c = expf(sm_m[w] - mx);
        ls += sm_l[w] * c;
        a += sm_acc[w][d] * c;
      }
      o[b * sob + j * soj + h * soh + d] = from_float<T>(a / fmaxf(ls, 1e-30f));
    }
  }
}

template <typename T>
static void launch(const void* q, const void* k, const void* v, void* o,
                   const int* lengths, const int* q_lens, int B, int Sq,
                   int H, int Hk, int S, int D, const long long* st,
                   float scale, int window, int ring, cudaStream_t stream) {
  const dim3 grid(Hk, B);
#define REPRO_FD_LAUNCH(DD)                                                   \
  flash_decode_kernel<T, DD><<<grid, FD_WARPS * 32, 0, stream>>>(             \
      static_cast<const T*>(q), static_cast<const T*>(k),                     \
      static_cast<const T*>(v), static_cast<T*>(o), lengths, q_lens, Sq, H,   \
      Hk, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],   \
      st[9], st[10], st[11], scale, window, ring)
  switch (D) {
    case 32: REPRO_FD_LAUNCH(32); break;
    case 64: REPRO_FD_LAUNCH(64); break;
    case 128: REPRO_FD_LAUNCH(128); break;
  }
#undef REPRO_FD_LAUNCH
}

}  // namespace repro_torch

// q (B, Sq, H, D), k/v (B, S, Hk, D), o like q, each given by its
// (batch, row-or-position, head) strides in elements; lengths (B,) int32;
// q_lens (B,) int32 or null (every row live).  Returns cudaGetLastError().
extern "C" int repro_flash_decode(
    const void* q, const void* k, const void* v, void* o, const void* lengths,
    const void* q_lens, int is_bf16, int B, int Sq, int H, int Hk, int S,
    int D, long long sqb, long long sqj, long long sqh, long long skb,
    long long sks, long long skh, long long svb, long long svs, long long svh,
    long long sob, long long soj, long long soh, float scale, int window,
    int ring, void* stream) {
  if (D != 32 && D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  const long long st[12] = {sqb, sqj, sqh, skb, sks, skh,
                            svb, svs, svh, sob, soj, soh};
  const int* len = static_cast<const int*>(lengths);
  const int* ql = static_cast<const int*>(q_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    repro_torch::launch<__nv_bfloat16>(q, k, v, o, len, ql, B, Sq, H, Hk, S,
                                       D, st, scale, window, ring, s);
  else
    repro_torch::launch<float>(q, k, v, o, len, ql, B, Sq, H, Hk, S, D, st,
                               scale, window, ring, s);
  return (int)cudaGetLastError();
}
