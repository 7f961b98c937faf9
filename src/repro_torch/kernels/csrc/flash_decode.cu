// Length-aware GQA flash-decode for Hopper (sm_90a): dense, int8, paged and
// paged int8 caches.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/decode_attention.py:
// flash_decode_attention (dense 16-bit), flash_decode_attention_quant (int8
// values with per-(position, head) f32 scales), flash_decode_attention_paged
// (a shared block pool read through per-slot block tables) and
// flash_decode_attention_paged_quant (both).  One decode step attends each
// slot's query rows against that slot's live KV prefix only, with the full,
// sliding-window and ring masks (16-bit layouts; the int8 ones take the full
// mask, as on the TPU), k-row speculative verify through q_lens, and exact
// zeros for empty slots and dead rows.
//
// What bounds it on the H100: memory.  A step reads every live K/V byte
// once (2 * live * Hk * D * 2 bytes per slot in bf16, half that plus
// 2 * live * Hk * 4 bytes of scales in int8) and does ~4 FLOP per byte, far
// below the ~295 FLOP/byte at which the tensor cores would bind.  The
// design reads only live keys and splits each slot's range over the block's
// warps so several loads are in flight per (slot, KV head).
//
// One kernel body, templated on the two things the four TPU kernels vary
// (the TPU file's "three fused variants share the one kernel body"):
// * how a key row is found -- dense strided, or paged: virtual position p
//   is row p % bs of physical block tables[b, p / bs].  The block loads its
//   slot's table row into shared memory once; the virtual space is
//   S = nb * bs and the masks are those of the dense kernel over virtual
//   positions.  Dead table entries point at the null block 0; no key outside
//   the live range is read, so block 0 is never read for a live slot.
// * how a row is stored -- 16-bit, or int8 with an f32 scale per (position,
//   head): s = (q . k_q) * k_s * scale, and the probability is multiplied
//   by v_s only after it has entered the row sum l, as in the TPU kernel's
//   _decode_kernel.  The scales are read in their (B, S, Hk) or
//   (N, bs, Hk) layout through strides; nothing is transposed or copied.
// The online-softmax loop (online_softmax.cuh) and the 4-warp split are
// shared by all four.
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
//   for the linear window band, else 0.  The clamp at S also covers the
//   free serving slots, whose lengths keep counting past S.
// * Rows are the TPU kernel's folded Sq * G rows (_prep_q): row r is draft
//   j = r / G of query head hk * G + r % G, so query head h reads KV head
//   h / G.  Rows are taken one after another; each re-reads the live K/V
//   (from L2 after the first row).  The serving path has one row per block
//   (Sq = 1, G = 1 for RecLLM), so it reads each live byte once.
// * Every tensor is read through its strides: a layer's view of the
//   stacked (L, B, S, Hk, D) cache or (L, N, bs, Hk, D) pool is passed as
//   it is.
// * Masks, per row j with eff = lengths + j (the causal intra-draft mask):
//   linear: pos < eff, and pos > eff - 1 - window when windowed; ring:
//   pos < min(eff, S) and floor_mod(eff - 1 - pos, S) < window -- a floor
//   modulo of a value that can be negative, where C++ % truncates; and the
//   draft cap j < q_lens.  A masked key's probability is 0 after the exp,
//   and l is floored at 1e-30, so a row with nothing to attend (len == 0,
//   j >= q_len) writes exact zeros.
// * q and o are float32 or bf16; K/V are q's type or int8; scores, softmax
//   and the output accumulate in float32; the scale multiplies q.k after
//   the dot, as on the TPU.
#include "online_softmax.cuh"

namespace repro_torch {

constexpr int FD_WARPS = 4;

__device__ __forceinline__ int floor_mod(int x, int n) {
  return ((x % n) + n) % n;
}

// Everything a launch needs, passed to the kernel by value.  Strides are
// in elements, three per tensor: q and o (batch, draft row, head); k, v
// and the scales (batch or physical block, position or row in block, head).
struct DecodeArgs {
  const void* q;
  void* o;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* lengths;
  const int* q_lens;  // null: every row live
  const int* tables;  // paged only: (B, nb) physical block ids
  int Sq, H, Hk;
  int S;   // positions (dense) or virtual positions nb * bs (paged)
  int nb;  // paged: table columns
  int bs;  // paged: rows per block
  long long sq[3], so[3], sk[3], sv[3], sks[3], svs[3];
  long long st;  // paged: table row stride
  float scale;
  int window, ring;
};

template <typename T, typename V, bool PAGED, int D>
__global__ void __launch_bounds__(FD_WARPS * 32)
    flash_decode_kernel(const DecodeArgs a) {
  constexpr int EPL = D / 32;
  extern __shared__ int table_s[];  // the slot's block-table row (paged)
  __shared__ float qs[D];
  __shared__ float sm_m[FD_WARPS], sm_l[FD_WARPS];
  __shared__ float sm_acc[FD_WARPS][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = a.H / a.Hk, S = a.S, window = a.window;
  const bool ring = a.ring != 0;
  const int length = a.lengths[b];
  const int q_len = a.q_lens != nullptr ? a.q_lens[b] : a.Sq;

  const int last = length + q_len - 1;  // the last live row's length
  const int hi = max(min(last, S), 0);
  const int lo = (window > 0 && !ring) ? max(length - window, 0) : 0;

  KVRows<V, PAGED> rows{};
  const long long slot_k = PAGED ? 0 : b * a.sk[0];
  const long long slot_v = PAGED ? 0 : b * a.sv[0];
  rows.k = static_cast<const V*>(a.k) + slot_k + hk * a.sk[2];
  rows.v = static_cast<const V*>(a.v) + slot_v + hk * a.sv[2];
  rows.k0 = a.sk[0];
  rows.k1 = a.sk[1];
  rows.v0 = a.sv[0];
  rows.v1 = a.sv[1];
  if constexpr (KVRows<V, PAGED>::kQuant) {
    rows.ks = a.ks + (PAGED ? 0 : b * a.sks[0]) + hk * a.sks[2];
    rows.vs = a.vs + (PAGED ? 0 : b * a.svs[0]) + hk * a.svs[2];
    rows.ks0 = a.sks[0];
    rows.ks1 = a.sks[1];
    rows.vs0 = a.svs[0];
    rows.vs1 = a.svs[1];
  }
  if constexpr (PAGED) {
    for (int i = threadIdx.x; i < a.nb; i += blockDim.x)
      table_s[i] = a.tables[b * a.st + i];
    rows.table = table_s;  // visible after the row loop's first barrier
    rows.bs = a.bs;
  }

  const T* q = static_cast<const T*>(a.q);
  T* o = static_cast<T*>(a.o);
  for (int r = 0; r < a.Sq * G; ++r) {
    const int j = r / G, h = hk * G + r % G;
    __syncthreads();  // the previous row is done with qs and sm_*
    const T* qrow = q + b * a.sq[0] + j * a.sq[1] + h * a.sq[2];
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
      warp_attend_rows<D>(qs, a.scale, rows, lo, hi, warp, FD_WARPS, valid,
                          m, l, acc);
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
      float ls = 0.f, acc_d = 0.f;
#pragma unroll
      for (int w = 0; w < FD_WARPS; ++w) {
        const float c = expf(sm_m[w] - mx);
        ls += sm_l[w] * c;
        acc_d += sm_acc[w][d] * c;
      }
      o[b * a.so[0] + j * a.so[1] + h * a.so[2] + d] =
          from_float<T>(acc_d / fmaxf(ls, 1e-30f));
    }
  }
}

template <typename T, bool QUANT, bool PAGED>
static void launch(const DecodeArgs& a, int B, int D, cudaStream_t stream) {
  using V = typename std::conditional<QUANT, int8_t, T>::type;
  const dim3 grid(a.Hk, B);
  const size_t smem = PAGED ? a.nb * sizeof(int) : 0;
  switch (D) {
    case 32:
      flash_decode_kernel<T, V, PAGED, 32><<<grid, FD_WARPS * 32, smem, stream>>>(a);
      break;
    case 64:
      flash_decode_kernel<T, V, PAGED, 64><<<grid, FD_WARPS * 32, smem, stream>>>(a);
      break;
    case 128:
      flash_decode_kernel<T, V, PAGED, 128><<<grid, FD_WARPS * 32, smem, stream>>>(a);
      break;
  }
}

template <bool QUANT, bool PAGED>
static int run(const void* q, void* o, const void* k, const void* v,
               const void* k_scale, const void* v_scale, const void* lengths,
               const void* q_lens, const void* tables, int is_bf16, int B,
               int Sq, int H, int Hk, int S, int bs, int D,
               const long long* strides, float scale, int window, int ring,
               void* stream) {
  if (D != 32 && D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  DecodeArgs a{};
  a.q = q;
  a.o = o;
  a.k = k;
  a.v = v;
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.lengths = static_cast<const int*>(lengths);
  a.q_lens = static_cast<const int*>(q_lens);
  a.tables = static_cast<const int*>(tables);
  a.Sq = Sq;
  a.H = H;
  a.Hk = Hk;
  a.nb = PAGED ? S : 0;
  a.bs = PAGED ? bs : 0;
  a.S = PAGED ? S * bs : S;
  long long* dst[6] = {a.sq, a.so, a.sk, a.sv, a.sks, a.svs};
  for (int t = 0; t < 6; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  a.st = strides[18];
  a.scale = scale;
  a.window = window;
  a.ring = ring;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16, QUANT, PAGED>(a, B, D, s);
  else
    launch<float, QUANT, PAGED>(a, B, D, s);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// The four entry points share one C signature.  q (B, Sq, H, D) and o like
// it, float32 or bf16 (is_bf16); k/v the cache values, q's type or int8;
// k_scale/v_scale the f32 scales of an int8 cache (else null); lengths
// (B,) int32; q_lens (B,) int32 or null (every row live); tables (B, nb)
// int32 for the paged layouts (else null).  S is the positions of a dense
// cache, or nb for a paged one; bs the block size (paged only).  strides:
// 19 element strides -- q, o, k, v, k_scale, v_scale, three each, then the
// table's row stride.  Returns cudaGetLastError().
#define REPRO_FD_ENTRY(NAME, QUANT, PAGED)                                      \
  extern "C" int NAME(const void* q, void* o, const void* k, const void* v,    \
                      const void* k_scale, const void* v_scale,                \
                      const void* lengths, const void* q_lens,                 \
                      const void* tables, int is_bf16, int B, int Sq, int H,   \
                      int Hk, int S, int bs, int D, const long long* strides,  \
                      float scale, int window, int ring, void* stream) {       \
    return repro_torch::run<QUANT, PAGED>(                                     \
        q, o, k, v, k_scale, v_scale, lengths, q_lens, tables, is_bf16, B, Sq, \
        H, Hk, S, bs, D, strides, scale, window, ring, stream);                \
  }

REPRO_FD_ENTRY(repro_flash_decode, false, false)
REPRO_FD_ENTRY(repro_flash_decode_quant, true, false)
REPRO_FD_ENTRY(repro_flash_decode_paged, false, true)
REPRO_FD_ENTRY(repro_flash_decode_paged_quant, true, true)
#undef REPRO_FD_ENTRY
