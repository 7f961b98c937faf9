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
// Two entry points share that row body (route_row) bit for bit:
//
// repro_moe_router: the router alone, ops.moe_router.  Bounded by bytes
// (read T*E*4, write T*E*4 + T*k*8); at the serving shapes a call moves a
// few KB, so a launch's fixed cost is what the caller sees.  One warp per
// token row, 8 rows per 256-thread block.
//
// repro_moe_route: everything the MoE FFN computes between the router
// product and the expert products (src/repro/models/moe.py:97-117), in one
// launch: the routing above, then each (token, slot)'s place in its
// expert's queue, then the dense (g, G, E, C) dispatch and combine tensors
// in the model dtype, and per group the expert loads and top-1 counts.
// Places are the reference's slot-major exclusive cumsum within a group:
// every token's slot 0 comes before any token's slot 1, a dead token (live
// mask 0) takes no place (its place reads 0, as the reference's sum over a
// masked one-hot), and a slot is kept when its place < C.  dispatch[t,e,c]
// = 1 and combine[t,e,c] = the gate where a kept live slot of token t chose
// expert e at place c, 0 elsewhere.  A token picks k distinct experts, so a
// (t, e) cell has at most one nonzero term and both tensors are exact: the
// plain version's einsums give the same bits.
//
// What bounds repro_moe_route on the H100: bytes.  dispatch and combine
// are 2 * G * E * C elements a group (2 MB at G = 256, E = 64, C = 32 in
// bf16) against G * E * 4 bytes of logits; at decode (G = 1) a call writes
// 16-32 KB and a launch's fixed cost dominates.  The plain version spends
// ~20 launches and a (g, k*G, E) cumsum on the same work.
//
// Design, groups of one token (decode: G = 1, a group a slot):
// moe_route_decode_kernel, one warp a group.  A token's k experts are
// distinct, so every slot takes place 0 and is kept; the block counts
// loads and top-1 choices with shared-memory integer atomics.
//
// Design, G > 1 (moe_route_kernel): a grid of (g, S) blocks, S slices of
// each group's tokens, so that one prompt's group (g = 1) spreads its
// dense writes over many SMs;
// W = min(32, max(ceil(E / 32), G)) warps a block.  Every block of a group
// (1) routes all G rows, one warp a row (rows t = warp, warp + W, ...),
// keeping each row's k expert ids in shared memory as bytes, and writes
// gates, idx and probs of its own slice only; (2) computes the places of
// every token, slot by slot: warp c takes tokens 32c .. 32c + 31 of slot
// j; a lane's rank among the lanes of its warp that chose the same expert
// is __popc(__match_any_sync(e) & lanemask_lt); the leader of each peer set
// writes the set's size to a (chunks, E) count table; thread e < E then
// turns column e into its exclusive prefix (plus the expert's running
// count over the earlier slots) and zeroes the counts.  Two barriers a
// slot, integer arithmetic only, no atomics: deterministic, and the same
// in every block of the group.  After slot 0 the running counts are the
// top-1 counts, after slot k-1 the loads; (3) writes its own tokens' (E,
// C) rows of dispatch and combine once, 16-byte stores of zeros with the
// token's k nonzeros placed in the vector that holds them (a per-warp list
// of the k flat offsets in shared memory, read as broadcasts); rows whose
// length is not a multiple of a 16-byte vector are written one element at
// a time.  No zero_() launch, no element written twice.  The routing is
// done S times over; it is the cheap part (G * E * 4 bytes of logits,
// read from L2 after the first block).
//
// Both kernels end in finish_counts: with one block (one prompt's group,
// or up to 32 decode slots) it writes the loads and top-1 shares itself;
// otherwise each block writes its partial counts and the last block to
// finish (an atomic ticket, reset by that block for the next launch) sums
// them in block order (integer-valued floats: exact).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_torch {

constexpr int MR_THREADS = 256;          // router: 8 warps, 8 rows a block
constexpr int MR_MAX_PER_LANE = 4;       // E <= 128
constexpr int MR_MAX_GROUP = 1024;       // route: G <= 1024 tokens a block
constexpr int MR_MAX_WARPS = 32;         // route: <= 1024 threads a block
// route's shared memory at most: two (32, 128) int tables, 32 warps' k
// offsets and the (1024, 128) byte ids, 180 KB
constexpr int MR_MAX_SMEM = 4 * (2 * 32 * 128 + 32 * 128) + 1024 * 128;

// One token row, one warp.  Lane l holds values l, l + 32, ... of its row
// in registers (NPER = ceil(E / 32) of them; lanes past E hold -inf).  The
// row max and the row sum are xor-shuffle butterflies: every lane ends
// with the same value in the same order, so there are no float atomics and
// the result is deterministic.  exp is expf and probs a true division (no
// fast-math: probs and gates are held to 1e-6 of the plain version).  Each
// top-k round reduces (value, index) pairs across the warp under the total
// order "greater value, or equal value and smaller index", so every lane
// agrees on the winner; the lane that holds it masks it.  The k raw gates
// stay in registers (round j in lane j % 32) until their sum is known.
// The TPU kernel does the same on a (block_t, E) VMEM tile with one lane
// tile per row; here a row never leaves one warp's registers.
//
// ``store`` false skips the gates, idx and probs writes; ``ids`` and
// ``gs``, when not null, get the k expert ids as bytes and the k gates
// (shared memory).  None of it touches the arithmetic.
template <int NPER>
__device__ __forceinline__ void route_row(const float* x, float* out_g,
                                          int* out_i, float* p, int E, int k,
                                          int lane, bool store,
                                          unsigned char* ids,
                                          float* gs = nullptr) {
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
#pragma unroll
  for (int j = 0; j < NPER; ++j) {
    const int e = lane + 32 * j;
    if (e < E) {
      v[j] = v[j] / s;
      if (store) p[e] = v[j];
    } else {
      v[j] = -INFINITY;                  // never wins a round
    }
  }

  float graw[MR_MAX_PER_LANE];
#pragma unroll
  for (int c = 0; c < MR_MAX_PER_LANE; ++c) graw[c] = 0.f;
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
      if (store) out_i[r] = bi;
      if (ids != nullptr) ids[r] = (unsigned char)bi;
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
#pragma unroll
  for (int c = 0; c < MR_MAX_PER_LANE; ++c) {
    const int r = lane + 32 * c;
    if (r < k) {
      const float gv = graw[c] / gsum;
      if (store) out_g[r] = gv;
      if (gs != nullptr) gs[r] = gv;
    }
  }
}

template <int NPER>
__global__ void __launch_bounds__(MR_THREADS) moe_router_kernel(
    const float* __restrict__ logits, float* __restrict__ gates,
    int* __restrict__ idx, float* __restrict__ probs, long long T, int E,
    int k) {
  const long long row = (long long)blockIdx.x * (MR_THREADS / 32)
                        + (threadIdx.x >> 5);
  if (row >= T) return;                  // whole warps only: no shuffle hangs
  route_row<NPER>(logits + row * E, gates + row * k, idx + row * k,
                  probs + row * E, E, k, threadIdx.x & 31, true, nullptr);
}

// The bits of one output element: dispatch and combine are written as
// raw 16- or 32-bit words, VEC of them to a 16-byte store.
template <typename T> struct Bits;
template <> struct Bits<float> {
  using U = unsigned int;
  static __device__ U of(float x) { return __float_as_uint(x); }
};
template <> struct Bits<__nv_bfloat16> {
  using U = unsigned short;
  static __device__ U of(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};
template <> struct Bits<__half> {
  using U = unsigned short;
  static __device__ U of(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
};

// One token's (E, C) rows of dispatch and combine, by one warp: 16-byte
// stores of zeros with the token's nonzeros placed in the vector that
// holds them (``flat``: the k flat offsets e * C + place of its kept
// slots, -1 for the others, in shared memory, read as broadcasts); rows
// whose length is not a multiple of a 16-byte vector one element at a
// time.  Every element is written once.
template <typename T>
__device__ __forceinline__ void fill_row(typename Bits<T>::U* drow,
                                         typename Bits<T>::U* crow,
                                         const int* flat, const float* g_row,
                                         int R, int k, int lane) {
  using U = typename Bits<T>::U;
  constexpr int VEC = 16 / sizeof(U);
  union Pack {
    uint4 v;
    U e[VEC];
  };
  const U one = Bits<T>::of(1.f);
  if (R % VEC == 0) {
    for (int q = lane; q < R / VEC; q += 32) {
      Pack d, c;
      d.v = make_uint4(0u, 0u, 0u, 0u);
      c.v = d.v;
      for (int j = 0; j < k; ++j) {
        const int f = flat[j] - q * VEC;
        if ((unsigned)f < (unsigned)VEC) {
          const U gv = Bits<T>::of(g_row[j]);
#pragma unroll
          for (int u = 0; u < VEC; ++u)
            if (f == u) {
              d.e[u] = one;
              c.e[u] = gv;
            }
        }
      }
      reinterpret_cast<uint4*>(drow)[q] = d.v;
      reinterpret_cast<uint4*>(crow)[q] = c.v;
    }
  } else {
    for (int q = lane; q < R; q += 32) {
      U dv = 0, cv = 0;
      for (int j = 0; j < k; ++j)
        if (flat[j] == q) {
          dv = one;
          cv = Bits<T>::of(g_row[j]);
        }
      drow[q] = dv;
      crow[q] = cv;
    }
  }
}

// Block x of the grid's gridDim.x holds the loads and top-1 counts of its
// groups (thread e < E: expert e's): one block writes the totals; else
// each writes its partial row x of counts, and the last to finish (the
// atomic ticket, which it resets for the next launch) sums the partial
// rows in order (integer-valued floats: exact) into row g, the top-1
// counts over g * G into shares.  Every thread of the block calls it.
__device__ __forceinline__ void finish_counts(float* counts,
                                              unsigned int* ticket,
                                              long long g, int G, int E,
                                              int load, int top1) {
  __shared__ int last;
  const long long parts = gridDim.x, part = blockIdx.x;
  const int e = threadIdx.x;
  float* tl = counts + g * E;                    // totals: loads
  float* tf = counts + (2 * g + 1) * E;          //   and top-1 shares
  if (parts == 1) {
    if (e < E) {
      tl[e] = (float)load;
      tf[e] = (float)top1 / (float)(g * G);
    }
    return;
  }
  if (e < E) {
    counts[part * E + e] = (float)load;
    counts[(g + 1 + part) * E + e] = (float)top1;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == (unsigned)(parts - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (e < E) {
    float l = 0.f, f = 0.f;
#pragma unroll 8
    for (long long q = 0; q < parts; ++q) {
      l += __ldcg(counts + q * E + e);
      f += __ldcg(counts + (g + 1 + q) * E + e);
    }
    tl[e] = l;
    tf[e] = f / (float)(g * G);
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// Groups of G > 1 tokens: a grid of (g, S) blocks, see the design notes.
template <int NPER, typename T>
__global__ void __launch_bounds__(MR_MAX_WARPS * 32, 1) moe_route_kernel(
    const float* __restrict__ logits, const unsigned char* __restrict__ live,
    float* gates, int* idx, float* __restrict__ probs, int* place,
    typename Bits<T>::U* __restrict__ dispatch,
    typename Bits<T>::U* __restrict__ combine, float* counts,
    unsigned int* ticket, int G, int E, int k, int C) {
  extern __shared__ int smem[];
  const long long g = gridDim.x;
  const int W = blockDim.x >> 5;
  const int nchunks = (G + 31) >> 5;             // <= W
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* cnt = smem;                               // (nchunks, E): a slot's
                                                 //   counts
  int* pre = cnt + nchunks * E;                  // (nchunks, E): their prefix
  int* flat = pre + nchunks * E + warp * k;      // this warp's k offsets
  unsigned char* ids =                           // (G, k) expert ids
      reinterpret_cast<unsigned char*>(pre + nchunks * E + W * k);
  const long long grp = blockIdx.x;
  const long long row0 = grp * G;
  const int per = (G + gridDim.y - 1) / gridDim.y;
  const int t0 = blockIdx.y * per;               // this block's tokens
  const int t1 = min(G, t0 + per);               //   [t0, t1)

  // (1) routing of the whole group; outputs of the own slice only
  for (int t = warp; t < G; t += W) {
    const long long r = row0 + t;
    route_row<NPER>(logits + r * E, gates + r * k, idx + r * k, probs + r * E,
                    E, k, lane, t >= t0 && t < t1, ids + t * k);
  }
  for (int i = threadIdx.x; i < nchunks * E; i += blockDim.x) cnt[i] = 0;
  __syncthreads();

  // (2) places, slot by slot; warp c < nchunks holds tokens 32c + lane
  const int t = 32 * warp + lane;
  const bool alive = warp < nchunks && t < G
                     && (live == nullptr || live[row0 + t] != 0);
  const bool own = t >= t0 && t < t1;
  int base = 0, top1 = 0;                        // thread e < E: expert e's
  for (int j = 0; j < k; ++j) {                  //   count over slots < j
    const int e = alive ? ids[t * k + j] : -1;
    int rank = 0;
    if (warp < nchunks) {                        // uniform across the warp
      const unsigned peers = __match_any_sync(0xffffffffu, e);
      rank = __popc(peers & ((1u << lane) - 1u));
      if (e >= 0 && rank == 0) cnt[warp * E + e] = __popc(peers);
    }
    __syncthreads();
    if (threadIdx.x < E) {
      const int x = threadIdx.x;
      for (int c = 0; c < nchunks; ++c) {
        const int n = cnt[c * E + x];
        pre[c * E + x] = base;
        base += n;
        cnt[c * E + x] = 0;
      }
      if (j == 0) top1 = base;
    }
    __syncthreads();
    if (own) place[(row0 + t) * k + j] = e >= 0 ? pre[warp * E + e] + rank
                                                : 0;
  }
  if (blockIdx.y == 0) finish_counts(counts, ticket, g, G, E, base, top1);
  __syncthreads();                               // places visible to (3)

  // (3) dense dispatch and combine of the own tokens
  for (int tt = t0 + warp; tt < t1; tt += W) {
    const long long r = row0 + tt;
    const bool on = live == nullptr || live[r] != 0;
    for (int j = lane; j < k; j += 32) {
      const int p = place[r * k + j];
      flat[j] = on && p < C ? ids[tt * k + j] * C + p : -1;
    }
    __syncwarp();
    fill_row<T>(dispatch + r * E * C, combine + r * E * C, flat, gates + r * k,
                E * C, k, lane);
    __syncwarp();                                // before flat is rewritten
  }
}

// Groups of one token (decode: a group a slot): a token's k experts are
// distinct, so every slot takes place 0 of its expert's queue and is kept
// (C >= 1).  One warp a group, W groups a block; the block counts its
// groups' loads and top-1 choices with shared-memory integer atomics
// (order-free, so deterministic).
template <int NPER, typename T>
__global__ void __launch_bounds__(MR_MAX_WARPS * 32, 1)
moe_route_decode_kernel(
    const float* __restrict__ logits, const unsigned char* __restrict__ live,
    float* gates, int* idx, float* __restrict__ probs, int* place,
    typename Bits<T>::U* __restrict__ dispatch,
    typename Bits<T>::U* __restrict__ combine, float* counts,
    unsigned int* ticket, long long g, int E, int k, int C) {
  extern __shared__ int smem[];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* loads = smem;                             // (E,) this block's
  int* tops = smem + E;                          // (E,)
  int* flat = smem + 2 * E + warp * k;           // this warp's: k offsets,
  float* gs = reinterpret_cast<float*>(smem + 2 * E + W * k) + warp * k;
  unsigned char* ids =                           //   k gates, k expert ids
      reinterpret_cast<unsigned char*>(smem + 2 * E + 2 * W * k) + warp * k;
  for (int i = threadIdx.x; i < 2 * E; i += blockDim.x) smem[i] = 0;
  __syncthreads();
  const long long grp = (long long)blockIdx.x * W + warp;
  if (grp < g) {
    route_row<NPER>(logits + grp * E, gates + grp * k, idx + grp * k,
                    probs + grp * E, E, k, lane, true, ids, gs);
    __syncwarp();                                // ids, gs visible
    const bool on = live == nullptr || live[grp] != 0;
    for (int j = lane; j < k; j += 32) {
      const int e = ids[j];
      place[grp * k + j] = 0;
      flat[j] = on ? e * C : -1;
      if (on) {
        atomicAdd(loads + e, 1);
        if (j == 0) atomicAdd(tops + e, 1);
      }
    }
    __syncwarp();
    fill_row<T>(dispatch + grp * E * C, combine + grp * E * C, flat, gs,
                E * C, k, lane);
  }
  __syncthreads();
  const int e = threadIdx.x;
  finish_counts(counts, ticket, g, 1, E, e < E ? loads[e] : 0,
                e < E ? tops[e] : 0);
}

// Blocks of 1024 threads hold one block an SM: the slices of a launch fill
// the SMs once (S = SMs / g, at least 1, at most one slice per 8 tokens).
inline int route_slices(long long g, int G) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 1;
  }
  long long S = sms / g;
  const long long most = (G + 7) / 8;
  if (S > most) S = most;
  if (S > 65535) S = 65535;
  return S < 1 ? 1 : (int)S;
}

template <int NPER, typename T>
int launch_route(const float* lg, const unsigned char* lv, float* ga,
                 int* ix, float* pr, int* pl, void* dsp, void* cmb,
                 float* cn, unsigned int* tk, long long g, int G, int E,
                 int k, int C, cudaStream_t s) {
  using U = typename Bits<T>::U;
  const int min_warps = (E + 31) / 32;           // a thread an expert
  if (G == 1) {
    int W = g < MR_MAX_WARPS ? (int)g : MR_MAX_WARPS;
    if (W < min_warps) W = min_warps;
    const size_t smem = sizeof(int) * (2 * (size_t)E + 2 * (size_t)W * k)
                        + (size_t)W * k;
    moe_route_decode_kernel<NPER, T>
        <<<(unsigned)((g + W - 1) / W), W * 32, smem, s>>>(
            lg, lv, ga, ix, pr, pl, static_cast<U*>(dsp),
            static_cast<U*>(cmb), cn, tk, g, E, k, C);
    return (int)cudaGetLastError();
  }
  int W = G < min_warps ? min_warps : G;
  if (W > MR_MAX_WARPS) W = MR_MAX_WARPS;
  const int nchunks = (G + 31) / 32;
  const size_t smem = sizeof(int) * (2 * (size_t)nchunks * E + (size_t)W * k)
                      + (size_t)G * k;
  // up to 180 KB (G 1024, k 128); the limit is raised once a process
  static const cudaError_t raised = cudaFuncSetAttribute(
      moe_route_kernel<NPER, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MR_MAX_SMEM);
  if (raised != cudaSuccess) return (int)raised;
  const dim3 grid((unsigned)g, (unsigned)route_slices(g, G));
  moe_route_kernel<NPER, T><<<grid, W * 32, smem, s>>>(
      lg, lv, ga, ix, pr, pl, static_cast<U*>(dsp), static_cast<U*>(cmb), cn,
      tk, G, E, k, C);
  return (int)cudaGetLastError();
}

template <typename T>
int route_dtype(int nper, const float* lg, const unsigned char* lv,
                float* ga, int* ix, float* pr, int* pl, void* dsp, void* cmb,
                float* cn, unsigned int* tk, long long g, int G, int E, int k,
                int C, cudaStream_t s) {
  if (nper == 1)
    return launch_route<1, T>(lg, lv, ga, ix, pr, pl, dsp, cmb, cn, tk, g, G,
                              E, k, C, s);
  if (nper == 2)
    return launch_route<2, T>(lg, lv, ga, ix, pr, pl, dsp, cmb, cn, tk, g, G,
                              E, k, C, s);
  if (nper == 3)
    return launch_route<3, T>(lg, lv, ga, ix, pr, pl, dsp, cmb, cn, tk, g, G,
                              E, k, C, s);
  return launch_route<4, T>(lg, lv, ga, ix, pr, pl, dsp, cmb, cn, tk, g, G, E,
                            k, C, s);
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

// logits (g, G, E) f32 contiguous, live (g, G) uint8 or null (every token
// live) -> gates (g, G, k) f32, idx (g, G, k) int32, probs (g, G, E) f32,
// place (g, G, k) int32, dispatch and combine (g, G, E, C) of dtype 0 f32 |
// 1 bf16 | 2 f16 (16-byte aligned), counts (2, g + 1, E) f32: the loads,
// then the top-1 counts, of each group, with row g the loads summed over
// the groups and the top-1 shares (counts / (g * G)).  ticket: one
// unsigned int, 0 before the launch and after it (launches that share a
// ticket run one at a time: one stream).  1 <= k <= E <= 128, 1 <= G <=
// 1024, C >= 1.
extern "C" int repro_moe_route(const void* logits, const void* live,
                               void* gates, void* idx, void* probs,
                               void* place, void* dispatch, void* combine,
                               void* counts, void* ticket, long long g,
                               int G, int E, int k, int C, int dtype,
                               void* stream) {
  using namespace repro_torch;
  if (E < 1 || E > 32 * MR_MAX_PER_LANE || k < 1 || k > E || G < 1
      || G > MR_MAX_GROUP || C < 1 || g < 0 || g > 2147483647LL
      || (long long)E * C > 2147483647LL || dtype < 0 || dtype > 2
      || reinterpret_cast<uintptr_t>(dispatch) % 16
      || reinterpret_cast<uintptr_t>(combine) % 16)
    return (int)cudaErrorInvalidValue;
  if (g == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lg = static_cast<const float*>(logits);
  const unsigned char* lv = static_cast<const unsigned char*>(live);
  float* ga = static_cast<float*>(gates);
  int* ix = static_cast<int*>(idx);
  float* pr = static_cast<float*>(probs);
  int* pl = static_cast<int*>(place);
  float* cn = static_cast<float*>(counts);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  const int nper = (E + 31) / 32;
  if (dtype == 0)
    return route_dtype<float>(nper, lg, lv, ga, ix, pr, pl, dispatch, combine,
                              cn, tk, g, G, E, k, C, s);
  if (dtype == 1)
    return route_dtype<__nv_bfloat16>(nper, lg, lv, ga, ix, pr, pl, dispatch,
                                      combine, cn, tk, g, G, E, k, C, s);
  return route_dtype<__half>(nper, lg, lv, ga, ix, pr, pl, dispatch, combine,
                             cn, tk, g, G, E, k, C, s);
}
