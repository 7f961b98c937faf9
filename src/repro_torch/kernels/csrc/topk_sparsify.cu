// Block-local top-k gradient sparsification for Hopper (sm_90a), paper
// Eq. 11, and the top-k sync's exact-k selection from the same row pass.
//
// Replaces the Pallas TPU kernel topk_sparsify.topk_sparsify
// (src/repro/kernels/topk_sparsify.py) and, for the sync, the lax.top_k +
// take_along_axis + scatter that follows it (src/repro/core/compression.py).
// Two entry points share one kernel body, one row of `block` values each:
//
// * repro_topk_sparsify -> kept, resid.  The TPU kernel runs k rounds of
//   "m = max of the masked magnitudes, then mask every magnitude >= m";
//   the last m is the threshold t, the k-th largest *distinct* magnitude,
//   or -1 (keep the whole row) when the row has fewer than k distinct
//   magnitudes.  kept = x where |x| >= t (else 0), resid = x - kept.
// * repro_topk_select -> idx, vals (k a row: largest |x| first, ties to
//   the lowest index, as lax.top_k), resid_sent = x minus those k values.
//
// What bounds it on the H100: bytes (sparsify reads 4 and writes 8 bytes an
// element, select 4 + 4 and 8 a row per value sent).  What stands in the
// way is the rounds' dependent chain: k warp-wide maxima a row, each after
// the last, so the design keeps each round short (no barrier, few values a
// lane) and many rows in flight.
//
// Design:
// * One warp a row, 4 rows a CUDA block, no block barrier anywhere.  A lane
//   holds the row's float4s 4 * (32 j + lane) .. + 3 in registers (16-byte
//   loads and stores; scalar ones when the row is not 16-byte aligned, in
//   the same slots), so rows of up to 32 * 4 * NV values, NV <= 32.  Slots
//   past the row hold NaN, which no compare takes.
// * A round is "m = the largest |x| below the last m": no masked copy of
//   the row; |x| is an operand modifier of the compares, so no magnitude
//   is kept in a register; the warp's max is one __reduce_max_sync over
//   the bits (non-negative floats and the -1 sentinel order as ints).  Max
//   and compares are exact in any order, so the threshold equals the TPU
//   kernel's bit for bit, and so do kept and resid.
// * Prune before the rounds.  Any subset of the row bounds t from below:
//   the k-th largest distinct lane maximum L (the 32 lane maxima sorted
//   across the warp, 15 shuffle steps) is <= t, so every magnitude >= t is
//   >= L.  For select, the k-th largest lane maximum counted with repeats
//   bounds the k-th largest magnitude likewise.  The candidates (|x| >= L)
//   are compacted in index order (four ballots a float4 column) into
//   shared memory, at most 8 a lane, and the rounds run over them only.  A
//   row with no such bound (k above 32, fewer than k distinct lane maxima:
//   rows of zeros, heavily tied rows) or with too many candidates runs the
//   rounds over the whole row instead; the rounds stop as soon as the row
//   is used up (sparsify) or k values are taken (select).
// * Select counts, in each round, the values at the round's magnitude (one
//   __reduce_add_sync) and writes them to idx/vals at the running count:
//   the one lane holding it when there is one, else in index order by
//   ballots.  The round that reaches k gives the last magnitude taken and
//   the index of the last value taken, which is all the output pass needs
//   to know which values were sent.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int TK_WARPS = 4;               // rows (warps) a CUDA block
constexpr int TK_MAX_NV = 32;             // float4 slots a lane: 4096 values
constexpr int TK_CPL = 8;                 // candidate slots a lane
constexpr unsigned TK_FULL = 0xffffffffu;

// The warp's largest of values that are >= 0 or -1: such floats order as
// their bits read as ints.
__device__ __forceinline__ float warp_max(float v) {
  return __int_as_float(__reduce_max_sync(TK_FULL, __float_as_int(v)));
}

// One value a lane, sorted across the warp, largest in lane 0 (bitonic).
__device__ __forceinline__ float warp_sort_desc(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float o = __shfl_xor_sync(TK_FULL, v, stride);
      const bool keep_max = ((lane & size) == 0) == ((lane & stride) == 0);
      v = keep_max ? fmaxf(v, o) : fminf(v, o);
    }
  return v;
}

// Rounds over J x C value slots a lane, in index order (j, lane, c); an
// empty slot holds NaN, which no compare takes.  Round r takes m = the
// largest |v| below the last m (-1 when none is left; the first round
// takes the largest).  COUNT: also count the values at each round's m,
// emit(j, c, rank) each of the first k in index order, and stop at the
// round whose count reaches k.  Returns the last m: the k-th largest
// distinct magnitude without COUNT, the k-th largest counted with repeats
// with it, -1 when the slots ran out first.  Every lane of the warp calls
// it with the same k.
template <int J, int C, bool COUNT, class Val, class Emit>
__device__ __forceinline__ float rounds(int k, Val val, Emit emit) {
  const unsigned lt = (1u << (threadIdx.x & 31)) - 1u;
  float m = __int_as_float(0x7fffffff);   // NaN: "a >= m" holds for none
  int taken = 0;
  for (int r = 0; r < k; ++r) {
    float local = -1.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float a = fabsf(val(j, c));
        if (!(a >= m)) local = fmaxf(local, a);
      }
    m = warp_max(local);
    if (m < 0.f) break;                  // the slots are used up
    if (COUNT) {
      int here = 0;
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int c = 0; c < C; ++c) here += fabsf(val(j, c)) == m;
      const int n = (int)__reduce_add_sync(TK_FULL, (unsigned)here);
      if (n == 1) {                      // one value: no order to find
        if (here) {
#pragma unroll
          for (int j = 0; j < J; ++j)
#pragma unroll
            for (int c = 0; c < C; ++c)
              if (fabsf(val(j, c)) == m) emit(j, c, taken);
        }
      } else {
        int rank = taken;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          bool hit[C];
          int mine = rank;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            hit[c] = fabsf(val(j, c)) == m;
            const unsigned b = __ballot_sync(TK_FULL, hit[c]);
            mine += __popc(b & lt);
            rank += __popc(b);
          }
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (hit[c]) {
              if (mine < k) emit(j, c, mine);
              ++mine;
            }
        }
      }
      taken += n;
      if (taken >= k) break;
    }
  }
  return m;
}

// One warp a row.  SELECT: out0 = vals (nb, k), idx (nb, k), out1 =
// resid_sent; else out0 = kept, out1 = resid.
template <int NV, bool SELECT>
__global__ void __launch_bounds__(32 * TK_WARPS) topk_rows_kernel(
    const float* __restrict__ x, float* __restrict__ out0,
    float* __restrict__ out1, int* __restrict__ idx, long long nb,
    int block, int k, int vec) {
  constexpr int CPL = 4 * NV < TK_CPL ? 4 * NV : TK_CPL;
  constexpr int CAP = 32 * CPL;
  __shared__ float cand_x[TK_WARPS][CAP];
  __shared__ int cand_i[TK_WARPS][CAP];
  __shared__ int cut_s[TK_WARPS];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * TK_WARPS + w;
  if (row >= nb) return;                 // the whole warp
  const long long base = row * block;
  const unsigned lt = (1u << lane) - 1u;
  const float none = __int_as_float(0x7fffffff);   // an empty slot

  float xs[4 * NV];
  if (vec) {
    const float4* xr = reinterpret_cast<const float4*>(x + base);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int q = 32 * j + lane;
      const float4 v = 4 * q < block ? __ldcs(xr + q)
                                     : make_float4(none, none, none, none);
      xs[4 * j] = v.x; xs[4 * j + 1] = v.y;
      xs[4 * j + 2] = v.z; xs[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * (32 * j + lane) + c;
        xs[4 * j + c] = i < block ? __ldcs(x + base + i) : none;
      }
  }
  float lane_max = -1.f;
#pragma unroll
  for (int e = 0; e < 4 * NV; ++e) lane_max = fmaxf(lane_max, fabsf(xs[e]));

  // the bound L from the sorted lane maxima (-1: none)
  float lower = -1.f;
  if (k > 0 && k <= 32) {
    const float s = warp_sort_desc(lane_max);
    if (SELECT) {
      lower = __shfl_sync(TK_FULL, s, k - 1);
    } else {
      const float prev = __shfl_up_sync(TK_FULL, s, 1);
      unsigned firsts = __ballot_sync(TK_FULL, s >= 0.f
                                      && (lane == 0 || s != prev));
      if (__popc(firsts) >= k) {
        for (int i = 1; i < k; ++i) firsts &= firsts - 1;
        lower = __shfl_sync(TK_FULL, s, __ffs(firsts) - 1);
      }
    }
  }

  // compact the candidates |x| >= L in index order
  int total = CAP + 1;
  if (lower >= 0.f) {
    total = 0;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      bool hit[4];
      int pos = total;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        hit[c] = fabsf(xs[4 * j + c]) >= lower;
        const unsigned b = __ballot_sync(TK_FULL, hit[c]);
        pos += __popc(b & lt);
        total += __popc(b);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (hit[c]) {
          if (pos < CAP) {
            cand_x[w][pos] = xs[4 * j + c];
            cand_i[w][pos] = 4 * (32 * j + lane) + c;
          }
          ++pos;
        }
    }
    __syncwarp();
  }

  const long long obase = row * k;
  float t;
  if (total <= CAP) {
    float cx[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int p = 32 * i + lane;
      cx[i] = p < total ? cand_x[w][p] : none;
    }
    t = rounds<CPL, 1, SELECT>(
        k, [&](int i, int) { return cx[i]; },
        [&](int i, int, int s) {
          const int ci = cand_i[w][32 * i + lane];
          idx[obase + s] = ci;
          out0[obase + s] = cx[i];
          if (s == k - 1) cut_s[w] = ci;
        });
  } else {
    t = rounds<NV, 4, SELECT>(
        k, [&](int j, int c) { return xs[4 * j + c]; },
        [&](int j, int c, int s) {
          const int i = 4 * (32 * j + lane) + c;
          idx[obase + s] = i;
          out0[obase + s] = xs[4 * j + c];
          if (s == k - 1) cut_s[w] = i;
        });
  }
  int cut = -1;
  if (k == 0) {
    t = SELECT ? none : INFINITY;        // none sent; kept |x| >= inf
  } else if (SELECT) {
    __syncwarp();
    cut = cut_s[w];
  }

  // kept = x where |x| >= t; sent = x where |x| > t or (|x| == t and the
  // index is at most the last one taken)
  float4* r0 = reinterpret_cast<float4*>(out0 + base);
  float4* r1 = reinterpret_cast<float4*>(out1 + base);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int q = 32 * j + lane;
    float o0[4], o1[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float v = xs[4 * j + c], a = fabsf(v);
      const bool on = SELECT ? a > t || (a == t && 4 * q + c <= cut)
                             : a >= t;
      o0[c] = on ? v : 0.f;
      o1[c] = v - o0[c];
    }
    if (vec) {
      if (4 * q < block) {
        __stcs(r1 + q, make_float4(o1[0], o1[1], o1[2], o1[3]));
        if (!SELECT) __stcs(r0 + q, make_float4(o0[0], o0[1], o0[2], o0[3]));
      }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * q + c < block) {
          __stcs(out1 + base + 4 * q + c, o1[c]);
          if (!SELECT) __stcs(out0 + base + 4 * q + c, o0[c]);
        }
    }
  }
}

template <bool SELECT>
int launch_rows(const void* x, void* out0, void* out1, void* idx,
                long long nb, int block, int k, void* stream) {
  if (block <= 0 || block > 128 * TK_MAX_NV || k < 0 || (SELECT && k > block)
      || nb < 0 || (nb + TK_WARPS - 1) / TK_WARPS > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaGetLastError();
  const uintptr_t a = reinterpret_cast<uintptr_t>(x)
      | reinterpret_cast<uintptr_t>(out1)
      | (SELECT ? 0 : reinterpret_cast<uintptr_t>(out0));
  const int vec = block % 4 == 0 && a % 16 == 0;
  const unsigned grid = (unsigned)((nb + TK_WARPS - 1) / TK_WARPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* o0 = static_cast<float*>(out0);
  float* o1 = static_cast<float*>(out1);
  int* ix = static_cast<int*>(idx);
  const int nv = (block + 127) / 128;
#define REPRO_TOPK_LAUNCH(NV)                                               \
  topk_rows_kernel<NV, SELECT><<<grid, 32 * TK_WARPS, 0, s>>>(             \
      xf, o0, o1, ix, nb, block, k, vec)
  if (nv <= 1) REPRO_TOPK_LAUNCH(1);
  else if (nv <= 2) REPRO_TOPK_LAUNCH(2);
  else if (nv <= 4) REPRO_TOPK_LAUNCH(4);
  else if (nv <= 8) REPRO_TOPK_LAUNCH(8);
  else if (nv <= 16) REPRO_TOPK_LAUNCH(16);
  else REPRO_TOPK_LAUNCH(32);
#undef REPRO_TOPK_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// x (nb, block) f32 contiguous -> kept, resid (nb, block) f32; any k >= 0.
extern "C" int repro_topk_sparsify(const void* x, void* kept, void* resid,
                                   long long nb, int block, int k,
                                   void* stream) {
  return repro_torch::launch_rows<false>(x, kept, resid, nullptr, nb, block,
                                         k, stream);
}

// x (nb, block) f32 contiguous, k <= block -> idx (nb, k) int32, vals
// (nb, k) f32, resid_sent (nb, block) f32.
extern "C" int repro_topk_select(const void* x, void* idx, void* vals,
                                 void* resid_sent, long long nb, int block,
                                 int k, void* stream) {
  return repro_torch::launch_rows<true>(x, vals, resid_sent, idx, nb, block,
                                        k, stream);
}
