// Prefill flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention.flash_attention
// (src/repro/kernels/flash_attention.py): blocked online-softmax attention,
// forward only, causal and/or sliding-window mask, GQA (query head h reads
// KV head h / G; K/V are never repeated).
//
// Function, kept from the TPU kernel: keys [lo, hi) of query row r pass
// the mask (pos_k < Sk, pos_k <= pos_q when causal, pos_k > pos_q - window
// when windowed), so hi = min(r + 1, Sk) when causal, lo = r - window + 1
// when windowed.  Any Sq / Sk, no padding: the wrapper hands in the
// strides of q, k, v and o, so the model's (B, S, H, D) tensors are read
// in place.  D is 32, 64 or 128; scores, softmax and the output
// accumulate in float32.  A row with no key in range writes exact zeros
// (the sum floored at 1e-30), the TPU kernel's result for a fully masked
// row.  NEG_INF is the finite -1e30 of online_softmax.cuh, and a masked
// key's probability is set to 0, never taken from the exp.
//
// What bounds it on the H100: at serving prompt lengths (tens to a few
// hundred tokens, head_dim 64) the work is tiny -- a 200-token causal
// head is ~5 MFLOP over ~100 KB, 0.4 us at the HBM rate for all 12 heads
// -- so the time is the launch and the chain of dependent steps inside a
// block: load a K tile, score it, softmax, load V, accumulate, merge.
// The design shortens that chain and keeps it on the tensor cores.
//
// bfloat16 (flash_attention_mma_kernel), the served dtype:
// * A block takes a 16-row query tile of one (b, h), the M of
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate): grid (ceil(Sq / 16), H,
//   B), 156 blocks at B = 1, H = 12, S = 200 on 132 SMs.  Its nw warps
//   split the tile's key range: warp w takes the 16-key tiles w, w + nw,
//   ..., each with its own (m, l, acc), and at the end the warps merge
//   them through shared memory.  nw is the most tiles any block of the
//   call walks, up to 4, so no warp is launched idle: a prompt of 16
//   tokens or fewer runs one warp a block, which writes its rows from
//   registers with no merge.
// * Tiles of 16 keys, the mma's K: the serve path's prompts are 8-48
//   tokens, where a 64-key tile did up to 8x the needed loads, products
//   and exps in the one chain every block waits on (the card measured
//   64-key tiles slower a launch than the per-row kernel they replace
//   there); at S = 200 the last rows walk 13 tiles, 3-4 a warp, each
//   warp's loads of its next tile overlapping the current one.
// * The block's key range is [lo(first row), hi(last row)); tiles start
//   at its lower end, so a tile that every row masks is never loaded.
//   The causal, window and Sk masks are applied only in edge tiles (those
//   that some row's range does not cover whole).
// * Loads: Q (16 rows, zero past Sq) comes into shared memory once with
//   16-byte cp.async and into registers by ldmatrix.  Each warp has one K
//   and one V buffer of 16 padded rows (a 16-byte shift a row keeps
//   ldmatrix free of bank conflicts) filled by coalesced 16-byte cp.async,
//   zero past the range; K of the warp's next tile is requested as soon
//   as the scores are taken and V of it as soon as P.V is done, so each
//   load overlaps the other half of the tile's work.  At most 39.2 KB a
//   block (D = 128, 4 warps): under the 48 KB default, no attribute.
// * Scores S = Q.K^T by ldmatrix + mma.sync, scaled in float32 after the
//   product (the per-row kernel scaled q in f32 before the dot; the
//   bfloat16 tolerance covers the difference), in the exp2 domain (scale
//   * log2 e).  Online softmax in registers: each thread holds two rows'
//   values, reduced over the row's quad by shuffles; the running sum is
//   kept per thread and summed over the quad once, at the end.
// * P.V: the S accumulator is repacked as the bf16 A fragment of P (the
//   m16n8 C layout of two n-tiles is the m16n8k16 A layout), V comes
//   through ldmatrix.trans.
// * Why mma.sync and not wgmma: at S = 200 the whole call is ~62 MFLOP,
//   0.06 us at the tensor-core peak, so the MMA rate is not the limit;
//   the load chain and the launch are.  wgmma's 64-row minimum per
//   warpgroup would put 64 query rows in a block: 48 blocks at S = 200
//   instead of 156, and four times the rows in every block's chain.
//
// float32 (flash_attention_rows_kernel): tensor cores would compute in
// TF32, which misses the 1e-4 float32 tolerance and the float32 serve
// run's token-exact streams, so float32 keeps FMAs on the per-row body:
// one warp owns one query row and walks its whole key range 32 keys at a
// time (warp_attend, online_softmax.cuh), q scaled before the dot.  Grid
// (ceil(Sq / 8), H, B), 8 warps a block.
#include "online_softmax.cuh"

#include <algorithm>

namespace repro_torch {

constexpr int FA_ROWS = 8;  // f32: query rows (warps) per block

template <int D>
__global__ void __launch_bounds__(FA_ROWS * 32) flash_attention_rows_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int H, int Hk,
    int Sq, int Sk, long long sqb, long long sqh, long long sqs,
    long long skb, long long skh, long long sks, long long svb,
    long long svh, long long svs, long long sob, long long soh,
    long long sos, float scale, int causal, int window) {
  constexpr int EPL = D / 32;
  __shared__ float qs[FA_ROWS][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * FA_ROWS + warp;
  if (row >= Sq) return;  // no block-wide barrier below: safe to leave
  const int hk = h / (H / Hk);

  const float* qrow = q + b * sqb + h * sqh + row * sqs;
  for (int d = lane; d < D; d += 32) qs[warp][d] = qrow[d] * scale;
  __syncwarp();

  const int hi = causal ? min(row + 1, Sk) : Sk;
  const int lo = window > 0 ? max(row - window + 1, 0) : 0;
  float m = NEG_INF, l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  warp_attend<float, D>(qs[warp], 1.f, k + b * skb + hk * skh,
                        v + b * svb + hk * svh, sks, svs, lo, hi, 0, 1,
                        [](int) { return true; }, m, l, acc);

  const float denom = fmaxf(l, 1e-30f);
  float* orow = o + b * sob + h * soh + row * sos + lane * EPL;
#pragma unroll
  for (int e = 0; e < EPL; ++e) orow[e] = acc[e] / denom;
}

// -- bfloat16: mma.sync tiles ------------------------------------------------

constexpr int MQ = 16;      // query rows a block (the mma's M)
constexpr int MW = 4;       // the most warps a block, splitting its keys
constexpr int MK = 16;      // keys a tile

// Shared memory of the mma kernel with nw warps: Q, then each warp's K
// and V tile, in bf16 elements; the merge reuses the same bytes as float32
// ((2 + OP) * MQ floats a warp) once every warp has left its key loop.
template <int D>
struct MmaSmem {
  static constexpr int P = D + 8;            // padded row
  static constexpr int OP = D + 8;           // merge row (f32)
  static constexpr int TILE = MK * P;
  static constexpr int bytes(int nw) { return (MQ + 2 * nw * MK) * P * 2; }
  static constexpr bool fits() {   // every nw: merge inside, 48 KB at most
    for (int nw = 1; nw <= MW; ++nw)
      if (nw * MQ * (2 + OP) * 4 > bytes(nw) || bytes(nw) > 48 * 1024)
        return false;
    return true;
  }
};

// Keys [kbeg, kend) that some row of the query tile at r0 attends.
__host__ __device__ __forceinline__ void tile_keys(int r0, int Sq, int Sk,
                                                   int causal, int window,
                                                   int& kbeg, int& kend) {
  const int r_end = r0 + MQ < Sq ? r0 + MQ : Sq;     // past the last row
  kbeg = window > 0 && r0 - window + 1 > 0 ? r0 - window + 1 : 0;
  kend = causal && r_end < Sk ? r_end : Sk;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));   // 0 bytes read: zero-fill
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// c += a (16x16 bf16, row) . b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi)))
             << 16;
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t; the C
// fragment holds rows g (c[0], c[1]) and g + 8 (c[2], c[3]) at columns
// 2t, 2t + 1.  A query row of the block is r0 + g + 8 i for i in {0, 1}.
template <int D>
__global__ void __launch_bounds__(MW * 32, 1) flash_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int H, int Hk, int Sq, int Sk, long long sqb, long long sqh,
    long long sqs, long long skb, long long skh, long long sks,
    long long svb, long long svh, long long svs, long long sob,
    long long soh, long long sos, float scale_log2, int causal,
    int window) {
  using L = MmaSmem<D>;
  constexpr int P = L::P, CH = D / 8;        // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nw = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * MQ;
  const int hk = h / (H / Hk);
  const int r_last = min(r0 + MQ, Sq) - 1;

  // the block's key range, and the bounds inside which no tile is masked
  int kbeg, kend;
  tile_keys(r0, Sq, Sk, causal, window, kbeg, kend);
  const int lo_max = window > 0 ? max(r_last - window + 1, 0) : 0;
  const int hi_min = causal ? min(r0 + 1, Sk) : Sk;
  const int ntiles = kend > kbeg ? (kend - kbeg + MK - 1) / MK : 0;
  int lo[2], hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    lo[i] = window > 0 ? max(r - window + 1, 0) : 0;
    hi[i] = causal ? min(r + 1, Sk) : Sk;
  }

  const __nv_bfloat16* qb = q + b * sqb + h * sqh;
  const __nv_bfloat16* kb = k + b * skb + hk * skh;
  const __nv_bfloat16* vb = v + b * svb + hk * svh;
  __nv_bfloat16* ks = qs + MQ * P + warp * 2 * L::TILE;
  __nv_bfloat16* vs = ks + L::TILE;

  for (int c = tid; c < MQ * CH; c += blockDim.x) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool ok = r0 + r < Sq;
    cp_async16(qs + r * P + col, qb + (ok ? r0 + r : 0) * sqs + col, ok);
  }
  cp_async_commit();
  // one tile of K or V rows into this warp's buffer, zero past kend
  auto load_tile = [&](__nv_bfloat16* dst, const __nv_bfloat16* src,
                       long long stride, int tile) {
    const int key0 = kbeg + tile * MK;
    for (int c = lane; c < MK * CH; c += 32) {
      const int r = c / CH, col = (c % CH) * 8, key = key0 + r;
      const bool ok = key < kend;
      cp_async16(dst + r * P + col, src + (ok ? key : 0) * stride + col,
                 ok);
    }
  };
  // every thread commits the same number of groups, empty ones included
  if (warp < ntiles) load_tile(ks, kb, sks, warp);
  cp_async_commit();
  if (warp < ntiles) load_tile(vs, vb, svs, warp);
  cp_async_commit();
  cp_async_wait<2>();
  __syncthreads();                           // Q is in shared memory

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
    ldmatrix_x4(qf[kd], qs + (lane & 15) * P + kd * 16 + (lane >> 4) * 8);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int tile = warp; tile < ntiles; tile += nw) {
    const int key0 = kbeg + tile * MK;
    cp_async_wait<1>();                      // K of this tile
    __syncwarp();
    float s[MK / 8][4];
#pragma unroll
    for (int n = 0; n < MK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
#pragma unroll
      for (int np = 0; np < MK / 16; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + (16 * np + (lane & 7) + (lane >> 4) * 8) * P +
                            16 * kd + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kd], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kd], bk[2], bk[3]);
      }
    __syncwarp();                            // every lane is done with ks
    const int next = tile + nw;
    if (next < ntiles) load_tile(ks, kb, sks, next);
    cp_async_commit();

    const bool edge = key0 < lo_max || key0 + MK > hi_min;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < MK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, key = key0 + 8 * n + 2 * t + (e & 1);
        float x = s[n][e] * scale_log2;
        if (edge && (key < lo[i] || key >= hi[i])) x = NEG_INF;
        s[n][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 2));
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < MK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = s[n][e] == NEG_INF ? 0.f : exp2f(s[n][e] - m[i]);
        s[n][e] = p;
        psum[i] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + psum[i];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    cp_async_wait<1>();                      // V of this tile
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (16 * kk + (lane & 15)) * P + 16 * nd +
                                  (lane >> 4) * 8);
        mma_bf16(acc[2 * nd], a, bv[0], bv[1]);
        mma_bf16(acc[2 * nd + 1], a, bv[2], bv[3]);
      }
    }
    __syncwarp();                            // every lane is done with vs
    if (next < ntiles) load_tile(vs, vb, svs, next);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL_MASK, l[i], 1);
    l[i] += __shfl_xor_sync(FULL_MASK, l[i], 2);
  }
  if (nw == 1) {                             // one warp: write from registers
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + g + 8 * i;
      if (r >= Sq) continue;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow = o + b * sob + h * soh + r * sos + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
    return;
  }

  // merge the warps' (m, l, acc) through shared memory, reused as float32
  __syncthreads();                           // every warp left its tiles
  float* ms = reinterpret_cast<float*>(smem);   // [nw][MQ]
  float* ls = ms + nw * MQ;                     // [nw][MQ]
  float* os = ls + nw * MQ;                     // [nw][MQ][OP]
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ms[warp * MQ + g + 8 * i] = m[i];
      ls[warp * MQ + g + 8 * i] = l[i];
    }
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(
          os + (warp * MQ + g + 8 * i) * L::OP + 8 * n + 2 * t) =
          make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  __syncthreads();

  for (int c = tid; c < MQ * CH; c += blockDim.x) {
    const int r = c / CH, col = (c % CH) * 8;
    if (r0 + r >= Sq) continue;
    float mm = NEG_INF;
    for (int w = 0; w < nw; ++w) mm = fmaxf(mm, ms[w * MQ + r]);
    float denom = 0.f, out[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int w = 0; w < nw; ++w) {
      const float f = exp2f(ms[w * MQ + r] - mm);   // 0 for a warp with no key
      denom += ls[w * MQ + r] * f;
      const float* src = os + (w * MQ + r) * L::OP + col;
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] += src[e] * f;
    }
    denom = fmaxf(denom, 1e-30f);
    *reinterpret_cast<uint4*>(o + b * sob + h * soh + (r0 + r) * sos +
                              col) =
        make_uint4(pack_bf16(out[0] / denom, out[1] / denom),
                   pack_bf16(out[2] / denom, out[3] / denom),
                   pack_bf16(out[4] / denom, out[5] / denom),
                   pack_bf16(out[6] / denom, out[7] / denom));
  }
}

template <int D>
static cudaError_t launch_mma(const void* q, const void* k, const void* v,
                              void* o, int B, int H, int Hk, int Sq, int Sk,
                              const long long* st, float scale, int causal,
                              int window, cudaStream_t stream) {
  // as many warps as the longest key range has tiles, up to MW: a prompt
  // of 16 tokens or fewer runs one warp a block and needs no merge
  int tiles = 1;
  for (int r0 = 0; r0 < Sq; r0 += MQ) {
    int kbeg, kend;
    tile_keys(r0, Sq, Sk, causal, window, kbeg, kend);
    tiles = std::max(tiles, (kend - kbeg + MK - 1) / MK);
  }
  static_assert(MmaSmem<D>::fits(), "shared memory of the mma kernel");
  const int nw = std::min(tiles, MW);
  const int bytes = MmaSmem<D>::bytes(nw);
  const dim3 grid((Sq + MQ - 1) / MQ, H, B);
  flash_attention_mma_kernel<D><<<grid, nw * 32, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, Hk, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale * 1.4426950408889634f, causal,
      window);
  return cudaGetLastError();
}

template <int D>
static cudaError_t launch_rows(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int Hk, int Sq, int Sk,
                               const long long* st, float scale, int causal,
                               int window, cudaStream_t stream) {
  const dim3 grid((Sq + FA_ROWS - 1) / FA_ROWS, H, B);
  flash_attention_rows_kernel<D><<<grid, FA_ROWS * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Hk, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale, causal, window);
  return cudaGetLastError();
}

}  // namespace repro_torch

// q (B, H, Sq, D), k/v (B, Hk, Sk, D), o like q, each given by its
// (batch, head, position) strides in elements.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int is_bf16, int B,
    int H, int Hk, int Sq, int Sk, int D, long long sqb, long long sqh,
    long long sqs, long long skb, long long skh, long long sks, long long svb,
    long long svh, long long svs, long long sob, long long soh, long long sos,
    float scale, int causal, int window, void* stream) {
  using namespace repro_torch;
  const long long st[12] = {sqb, sqh, sqs, skb, skh, sks,
                            svb, svh, svs, sob, soh, sos};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FA_ARGS \
  q, k, v, o, B, H, Hk, Sq, Sk, st, scale, causal, window, s
  if (is_bf16) {
    switch (D) {
      case 32: return (int)launch_mma<32>(REPRO_FA_ARGS);
      case 64: return (int)launch_mma<64>(REPRO_FA_ARGS);
      case 128: return (int)launch_mma<128>(REPRO_FA_ARGS);
    }
  } else {
    switch (D) {
      case 32: return (int)launch_rows<32>(REPRO_FA_ARGS);
      case 64: return (int)launch_rows<64>(REPRO_FA_ARGS);
      case 128: return (int)launch_rows<128>(REPRO_FA_ARGS);
    }
  }
#undef REPRO_FA_ARGS
  return (int)cudaErrorInvalidValue;
}
