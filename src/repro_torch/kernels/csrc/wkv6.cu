// Chunked WKV6 for Hopper (sm_90a): the RWKV-6 time-mix recurrence,
// parallel over chunks.
//
// Replaces the Pallas TPU kernel wkv6.wkv6_chunked
// (src/repro/kernels/wkv6.py): over float32 (B, H, T, hs) streams r, k, v,
// w (decay in (0, 1)) and a (H, hs) bonus u, from a zero state,
//   o_t = r_t (S_{t-1} + diag(u) k_t v_t^T),
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T.
// Beyond the TPU kernel it also writes the final state S_T (B, H, hs, hs)
// f32, which the serving prefill scatters into the request's slot.  The
// math is src/repro/models/ssm.py's _wkv6_chunked: per chunk of L tokens,
// with cum_t = sum_{s<=t} log w_s (per channel, <= 0, from the chunk's
// start),
//   o_t = sum_{s<t} (sum_c r_tc exp(cum_{t-1,c} - cum_sc) k_sc) v_s
//       + (r_t * exp(cum_{t-1})) S + (sum_c r_tc u_c k_tc) v_t,
//   S'  = diag(exp(cum_L)) S + sum_s (k_s * exp(cum_L - cum_s)) v_s^T;
// every exponent is <= 0 (clamped so), so w = 1e-6 underflows to its true
// ~0 instead of overflowing.  Logs and exps are taken base 2.
//
// What bounds it on the H100: bytes.  Read r, k, v, w once and write o and
// S_T once: 168 MB at B * H = 32, T = 4096, hs = 64 (0.050 ms at 3.35
// TB/s), 2.5 MB for a 48-token prefill; the float32 operations, ~20 a
// token and channel, come to about a third of that.  The design below
// also writes and reads back a float32 record a chunk (o_intra, r
// exp(cum_{t-1}), dS, exp(cum_L)): about 2.9x the bound's bytes at T =
// 4096, the price of running the chunks in parallel.
//
// Design: the chunks in parallel, then the state carried across them.
//
// * wkv6_intra_kernel, grid (chunks, B * H), 256 threads, 3 blocks an SM:
//   everything that depends on one chunk alone.  The chunk's (L, hs)
//   tiles of r, k, v and log2 w are loaded with 16-byte loads through the
//   caller's strides (rows padded to 68 floats; pad rows and channels are
//   r = k = v = 0, log w = 0, so a ragged last chunk is exact).  The
//   running sums take four 64-thread segments and a carry.  M[t][s]
//   (s < t) is computed in 4 x 4 tiles, each split over 8 groups of 8
//   channels (float4 reads) summed by shuffles.  Below the diagonal a
//   tile factors its decay through the last row p of its column group,
//   exp(cum_{t-1} - cum_p) * exp(cum_p - cum_s), both exponents <= 0 (the
//   one factorisation that cannot overflow): 8 exps a channel for 16
//   products.  Only the 4 x 4 tiles on the diagonal take pairwise exps;
//   their diagonal is the bonus sum_c r u k.  Then o_intra = M v (rows t
//   and L-1-t a thread, 4 columns: equal work) and the chunk's state
//   increment dS = sum_s (k_s exp(cum_L - cum_s)) v_s^T (4 x 4 a thread).
//   With one chunk (T <= 16) these are o and S_T, written directly, and
//   nothing else is launched; else o_intra, r * exp(cum_{t-1}), dS and
//   the decay exp(cum_L) go to a float32 workspace, one record a chunk.
// * wkv6_span_kernel, only when there are more than 32 chunks: one thread
//   an element of S walks every record but the last segment's with one
//   FMA each, S = exp(cum_L) S + dS, and writes S at each boundary of 32
//   records: the state entering each carry segment.
// * wkv6_carry_kernel, grid (B * H * ceil(hs / 16), segments): a block a
//   (b, h), 16 value columns of S (each column of S is its own
//   recurrence) and a segment walks its records in order from the state
//   the span kernel left (zeros for the first), staged three deep with
//   16-byte cp.async: o = o_intra + (r exp(cum_{t-1})) S, a row and 4
//   columns a thread (float4 reads of the state; with 16-token tiles two
//   threads split the channels), then S = exp(cum_L) S + dS.  No pairwise
//   exp is in this serial part.  The last segment writes S_T.  The walk
//   is latency-bound, one record after another; the segments give it
//   4 x as many blocks at T = 4096.
//
// The tile is L = 16 tokens for T <= 64 (rwkv6's serving prompts: 3
// chunks of a 48-token prefill, 96 + 128 blocks) and 32 beyond (T = 4096:
// 4096 intra blocks, 512 carry blocks); the caller's chunk is not the
// kernel's tile: the function is one function.  Sums run in a fixed order
// (no atomics), so the result is deterministic.  A programmatic dependent
// launch of the carry kernel (started early, waiting for the records) was
// slower on the H100 than a plain launch, and was taken out.
#include <cuda_runtime.h>
#include <math.h>

namespace repro_torch {

constexpr int WKV_HS = 64;              // widest head: state rows and columns
constexpr int WKV_LD = WKV_HS + 4;      // padded tile row: 16-byte aligned
constexpr int WKV_THREADS = 256;        // intra kernel: 4 x 64 (scan)
constexpr int WKV_NCG = 8;              // channel groups of an M tile
constexpr int WKV_INTRA_BLOCKS = 3;     // resident an SM: <= 85 registers
constexpr int WKV_COLS = 16;            // value columns of a carry block
constexpr int WKV_STAGES = 3;           // chunk records staged (carry)
constexpr int WKV_SEG = 32;             // chunk records a carry segment

// carry threads: a row and 4 columns each, over all channels or (16-token
// tiles) half of them
__host__ __device__ constexpr int carry_split(int L) {
  return L < 32 ? 2 : 1;
}
__host__ __device__ constexpr int carry_threads(int L) {
  return L * WKV_COLS / 4 * carry_split(L);
}

struct WkvArgs {
  const float *r, *k, *v, *w, *u;
  float *o, *s_out, *ws;
  long long sr[3], sk[3], sv[3], sw[3], so[3];   // (b, h, t); c stride 1
  int H, T, hs, nc, nseg, vec;                   // vec: 16-byte access
};

// one chunk's workspace record: o_intra (L, 64), r * exp(cum_{t-1})
// (L, 64), dS (64, 64), exp(cum_L) (64)
__host__ __device__ constexpr long long wkv_record(int L) {
  return 2LL * L * WKV_HS + WKV_HS * WKV_HS + WKV_HS;
}

template <int L>
struct IntraSmem {
  float r[L][WKV_LD], k[L][WKV_LD], v[L][WKV_LD];
  float cum[L][WKV_LD];   // log2 w, then its running sum
  float kt[L][WKV_LD];    // k * exp(cum_L - cum_s): dS's k side
  float M[L][L + 1];      // s < t, the bonus on the diagonal
  float u[WKV_HS];
  float tot[4][WKV_HS];   // scan segments' totals
};

template <int L>
struct CarrySmem {
  struct Record {
    float rt[L][WKV_LD];
    float oi[L][WKV_COLS];
    float ds[WKV_HS][WKV_COLS];
    float a[WKV_HS];
  } rec[WKV_STAGES];
  float S[WKV_HS][WKV_COLS];
  float part[L][WKV_COLS];   // the second channel half's sums
};

__device__ __forceinline__ float4 f4(float x) {
  return make_float4(x, x, x, x);
}

__device__ __forceinline__ float4 fma4(float a, float4 b, float4 c) {
  return make_float4(fmaf(a, b.x, c.x), fmaf(a, b.y, c.y), fmaf(a, b.z, c.z),
                     fmaf(a, b.w, c.w));
}

__device__ __forceinline__ float4& at4(float* p) {
  return *reinterpret_cast<float4*>(p);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, c))));
}

__device__ __forceinline__ float dexp(float x) {   // 2^min(x, 0)
  return exp2f(fminf(x, 0.f));
}

// 4 channels c.. of one row (zeros past hs); 16-byte load when vec
__device__ __forceinline__ float4 load4(const float* row, int c, int hs,
                                        int vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(row + c));
  float x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = c + i < hs ? __ldg(row + c + i) : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(float* row, int c, int hs, int vec,
                                       float4 x) {
  if (vec) {
    at4(row + c) = x;
    return;
  }
  const float y[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (c + i < hs) row[c + i] = y[i];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int L>
__global__ void __launch_bounds__(WKV_THREADS, WKV_INTRA_BLOCKS)
wkv6_intra_kernel(const WkvArgs a) {
  extern __shared__ float4 smem4[];
  IntraSmem<L>& s = *reinterpret_cast<IntraSmem<L>*>(smem4);
  const int tid = threadIdx.x, n = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H, hs = a.hs, vec = a.vec;
  const int t0 = n * L, live = min(L, a.T - t0);
  const bool direct = a.nc == 1;       // the chunk is the whole sequence
  float* rec = direct ? nullptr
                      : a.ws + ((long long)bh * a.nc + n) * wkv_record(L);

  // the chunk's tiles; log2 w in cum
  {
    const float* rp = a.r + b * a.sr[0] + h * a.sr[1] + t0 * a.sr[2];
    const float* kp = a.k + b * a.sk[0] + h * a.sk[1] + t0 * a.sk[2];
    const float* vp = a.v + b * a.sv[0] + h * a.sv[1] + t0 * a.sv[2];
    const float* wp = a.w + b * a.sw[0] + h * a.sw[1] + t0 * a.sw[2];
    for (int i = tid; i < L * (WKV_HS / 4); i += WKV_THREADS) {
      const int t = i >> 4, c = (i & 15) * 4;
      float4 x = f4(0.f), y = f4(0.f), z = f4(0.f), lw = f4(0.f);
      if (t < live && c < hs) {
        x = load4(rp + t * a.sr[2], c, hs, vec);
        y = load4(kp + t * a.sk[2], c, hs, vec);
        z = load4(vp + t * a.sv[2], c, hs, vec);
        const float4 ww = load4(wp + t * a.sw[2], c, hs, vec);
        // 1e-30: a subnormal floor may flush to zero -> log(0)
        lw = make_float4(log2f(fmaxf(ww.x, 1e-30f)),
                         c + 1 < hs ? log2f(fmaxf(ww.y, 1e-30f)) : 0.f,
                         c + 2 < hs ? log2f(fmaxf(ww.z, 1e-30f)) : 0.f,
                         c + 3 < hs ? log2f(fmaxf(ww.w, 1e-30f)) : 0.f);
      }
      at4(&s.r[t][c]) = x;
      at4(&s.k[t][c]) = y;
      at4(&s.v[t][c]) = z;
      at4(&s.cum[t][c]) = lw;
    }
    if (tid < WKV_HS) s.u[tid] = tid < hs ? a.u[h * hs + tid] : 0.f;
  }
  __syncthreads();

  // running sums: four segments of L / 4 rows a channel, then the carry
  {
    constexpr int SEG = L / 4;
    const int c = tid & (WKV_HS - 1), seg = tid >> 6;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < SEG; ++i) {
      acc += s.cum[seg * SEG + i][c];
      s.cum[seg * SEG + i][c] = acc;
    }
    s.tot[seg][c] = acc;
    __syncthreads();
    float off = 0.f;
    for (int j = 0; j < seg; ++j) off += s.tot[j][c];
#pragma unroll
    for (int i = 0; i < SEG; ++i) s.cum[seg * SEG + i][c] += off;
  }
  __syncthreads();

  // dS's k side; r * exp(cum_{t-1}) and exp(cum_L) for the carry kernel
  for (int i = tid; i < L * (WKV_HS / 4); i += WKV_THREADS) {
    const int t = i >> 4, c = (i & 15) * 4;
    const float4 cs = at4(&s.cum[t][c]), cl = at4(&s.cum[L - 1][c]);
    const float4 kk = at4(&s.k[t][c]);
    at4(&s.kt[t][c]) = make_float4(kk.x * dexp(cl.x - cs.x),
                                   kk.y * dexp(cl.y - cs.y),
                                   kk.z * dexp(cl.z - cs.z),
                                   kk.w * dexp(cl.w - cs.w));
    if (!direct) {
      const float4 cp = t ? at4(&s.cum[t - 1][c]) : f4(0.f);
      const float4 rr = at4(&s.r[t][c]);
      at4(rec + L * WKV_HS + t * WKV_HS + c) =
          make_float4(rr.x * dexp(cp.x), rr.y * dexp(cp.y),
                      rr.z * dexp(cp.z), rr.w * dexp(cp.w));
      if (t == 0)
        at4(rec + 2 * L * WKV_HS + WKV_HS * WKV_HS + c) =
            make_float4(dexp(cl.x), dexp(cl.y), dexp(cl.z), dexp(cl.w));
    }
  }
  __syncthreads();

  // M in 4 x 4 tiles (t group tg, s group sg), the tiles below the
  // diagonal first; an item is one tile's channels 4 cg.. and 4 cg + 32..
  {
    constexpr int G = L / 4, NOFF = G * (G - 1) / 2;
    constexpr int ITEMS = (NOFF + G) * WKV_NCG;
    const int lane = tid & 31;
    for (int base = tid - lane; base < ITEMS; base += WKV_THREADS) {
      const int item = base + lane, tile = item / WKV_NCG;
      const int cg = item % WKV_NCG;
      float acc[4][4] = {};
      int tg = 0, sg = 0;
      if (tile < NOFF) {
        int rem = tile;
        for (tg = 1; rem >= tg; ++tg) rem -= tg;
        sg = rem;
        const int p = 4 * sg + 3;          // the factorisation's boundary
#pragma unroll
        for (int c = 4 * cg; c < WKV_HS; c += 4 * WKV_NCG) {
          const float4 cpp = at4(&s.cum[p][c]);
          float4 rf[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int t = 4 * tg + q;
            const float4 rr = at4(&s.r[t][c]), cp = at4(&s.cum[t - 1][c]);
            rf[q] = make_float4(rr.x * dexp(cp.x - cpp.x),
                                rr.y * dexp(cp.y - cpp.y),
                                rr.z * dexp(cp.z - cpp.z),
                                rr.w * dexp(cp.w - cpp.w));
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 kk = at4(&s.k[4 * sg + j][c]);
            const float4 cs = at4(&s.cum[4 * sg + j][c]);
            const float4 kv = make_float4(kk.x * dexp(cpp.x - cs.x),
                                          kk.y * dexp(cpp.y - cs.y),
                                          kk.z * dexp(cpp.z - cs.z),
                                          kk.w * dexp(cpp.w - cs.w));
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[i][j] = dot4(rf[i], kv, acc[i][j]);
          }
        }
      } else if (tile < NOFF + G) {
        tg = sg = tile - NOFF;
#pragma unroll
        for (int c = 4 * cg; c < WKV_HS; c += 4 * WKV_NCG) {
          const float4 uc = at4(&s.u[c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 ri = at4(&s.r[4 * tg + i][c]);
            const float4 ki = at4(&s.k[4 * tg + i][c]);
            acc[i][i] = dot4(make_float4(ri.x * uc.x, ri.y * uc.y,
                                         ri.z * uc.z, ri.w * uc.w),
                             ki, acc[i][i]);
            if (i == 0) continue;
            const float4 cp = at4(&s.cum[4 * tg + i - 1][c]);   // cum_{t-1}
#pragma unroll
            for (int j = 0; j < i; ++j) {
              const float4 kj = at4(&s.k[4 * tg + j][c]);
              const float4 cj = at4(&s.cum[4 * tg + j][c]);
              const float4 e = make_float4(ri.x * dexp(cp.x - cj.x),
                                           ri.y * dexp(cp.y - cj.y),
                                           ri.z * dexp(cp.z - cj.z),
                                           ri.w * dexp(cp.w - cj.w));
              acc[i][j] = dot4(e, kj, acc[i][j]);
            }
          }
        }
      }
#pragma unroll
      for (int off = 1; off < WKV_NCG; off <<= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);
      if (cg == 0 && tile < NOFF + G) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (tile < NOFF || j <= i)
              s.M[4 * tg + i][4 * sg + j] = acc[i][j];
      }
    }
  }
  __syncthreads();

  // o_intra = M v: rows t1 and L - 1 - t1, 4 columns a thread
  if (tid < L / 2 * 16) {
    const int t1 = tid >> 4, t2 = L - 1 - t1, j = (tid & 15) * 4;
    float4 o1 = f4(0.f), o2 = f4(0.f);
    for (int sj = 0; sj <= t2; ++sj) {
      const float4 vv = at4(&s.v[sj][j]);
      o2 = fma4(s.M[t2][sj], vv, o2);
      if (sj <= t1) o1 = fma4(s.M[t1][sj], vv, o1);
    }
    if (direct) {
      float* op = a.o + b * a.so[0] + h * a.so[1] + t0 * a.so[2];
      if (t1 < live && j < hs) store4(op + t1 * a.so[2], j, hs, vec, o1);
      if (t2 < live && j < hs) store4(op + t2 * a.so[2], j, hs, vec, o2);
    } else {
      at4(rec + t1 * WKV_HS + j) = o1;
      at4(rec + t2 * WKV_HS + j) = o2;
    }
  }
  // dS = sum_s kt_s v_s^T: rows ci.., columns j.. (4 x 4 a thread)
  {
    const int ci = (tid >> 4) * 4, j = (tid & 15) * 4;
    float4 acc[4] = {f4(0.f), f4(0.f), f4(0.f), f4(0.f)};
#pragma unroll 4
    for (int sj = 0; sj < L; ++sj) {
      const float4 kk = at4(&s.kt[sj][ci]), vv = at4(&s.v[sj][j]);
      acc[0] = fma4(kk.x, vv, acc[0]);
      acc[1] = fma4(kk.y, vv, acc[1]);
      acc[2] = fma4(kk.z, vv, acc[2]);
      acc[3] = fma4(kk.w, vv, acc[3]);
    }
    if (direct) {
      float* sp = a.s_out + (long long)bh * hs * hs;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (ci + q < hs && j < hs)
          store4(sp + (ci + q) * hs, j, hs, vec, acc[q]);
    } else {
      float* dp = rec + 2 * L * WKV_HS;
#pragma unroll
      for (int q = 0; q < 4; ++q) at4(dp + (ci + q) * WKV_HS + j) = acc[q];
    }
  }
}

// The state entering each carry segment but the first, from the records'
// decays and increments alone: one thread an element (c, j) of S.
template <int L>
__global__ void __launch_bounds__(WKV_THREADS) wkv6_span_kernel(
    const WkvArgs a) {
  const int bh = blockIdx.y, e = blockIdx.x * WKV_THREADS + threadIdx.x;
  const int c = e / WKV_HS;
  const long long rl = wkv_record(L);
  const float* rec = a.ws + (long long)bh * a.nc * rl + 2 * L * WKV_HS;
  float* bnd = a.ws + (long long)gridDim.y * a.nc * rl +
               (long long)bh * (a.nseg - 1) * WKV_HS * WKV_HS + e;
  float S = 0.f;
  for (int g = 0; g + 1 < a.nseg; ++g) {
#pragma unroll 8
    for (int i = 0; i < WKV_SEG; ++i, rec += rl)
      S = fmaf(__ldg(rec + WKV_HS * WKV_HS + c), S, __ldg(rec + e));
    bnd[g * WKV_HS * WKV_HS] = S;
  }
}

// blockIdx.y: the segment of WKV_SEG records this block walks, from the
// state the span kernel left for it (zeros for the first)
template <int L>
__global__ void __launch_bounds__(carry_threads(L)) wkv6_carry_kernel(
    const WkvArgs a) {
  using Record = typename CarrySmem<L>::Record;
  constexpr int NT = carry_threads(L);
  extern __shared__ float4 smem4[];
  CarrySmem<L>& s = *reinterpret_cast<CarrySmem<L>*>(smem4);
  const int ncol = (a.hs + WKV_COLS - 1) / WKV_COLS, seg = blockIdx.y;
  const int bh = blockIdx.x / ncol, j0 = (blockIdx.x - bh * ncol) * WKV_COLS;
  const int b = bh / a.H, h = bh - b * a.H, tid = threadIdx.x;
  const long long rl = wkv_record(L);
  const float* recs = a.ws + (long long)bh * a.nc * rl;
  // the span kernel's states follow the records: BH * nc * rl floats
  const float* bnd = a.ws + (long long)gridDim.x / ncol * a.nc * rl +
                     (long long)bh * (a.nseg - 1) * WKV_HS * WKV_HS;
  for (int i = tid; i < WKV_HS * WKV_COLS; i += NT) {
    const int c = i / WKV_COLS, jj = i % WKV_COLS;
    s.S[c][jj] =
        seg ? bnd[(seg - 1) * WKV_HS * WKV_HS + c * WKV_HS + j0 + jj] : 0.f;
  }
  const int n0 = seg * WKV_SEG, n1 = min(a.nc, n0 + WKV_SEG);

  auto fetch = [&](int n) {            // record n, this block's columns
    Record& st = s.rec[(n - n0) % WKV_STAGES];
    const float* rec = recs + n * rl;
    for (int x = tid; x < L * (WKV_HS / 4); x += NT) {
      const int t = x >> 4, c = (x & 15) * 4;
      cp_async16(&st.rt[t][c], rec + (L + t) * WKV_HS + c);
    }
    for (int x = tid; x < L * (WKV_COLS / 4); x += NT) {
      const int t = x / (WKV_COLS / 4), c = x % (WKV_COLS / 4) * 4;
      cp_async16(&st.oi[t][c], rec + t * WKV_HS + j0 + c);
    }
    for (int x = tid; x < WKV_HS * (WKV_COLS / 4); x += NT) {
      const int c = x / (WKV_COLS / 4), j = x % (WKV_COLS / 4) * 4;
      cp_async16(&st.ds[c][j], rec + (2 * L + c) * WKV_HS + j0 + j);
    }
    if (tid < WKV_HS / 4)
      cp_async16(&st.a[tid * 4],
                 rec + 2 * L * WKV_HS + WKV_HS * WKV_HS + tid * 4);
  };
  for (int n = n0; n < n0 + WKV_STAGES - 1; ++n) {
    if (n < n1) fetch(n);
    cp_async_commit();
  }

  // a thread's output: row t, columns jq.. jq + 3 of the block's, over
  // channel half kh
  constexpr int KS = carry_split(L), CH = WKV_HS / KS;
  const int kh = tid / (NT / KS), tr = tid % (NT / KS);
  const int t = tr / (WKV_COLS / 4), jq = tr % (WKV_COLS / 4) * 4;
  const bool live_cols = j0 + jq < a.hs && kh == 0;
  float* op = a.o + b * a.so[0] + h * a.so[1] + j0 + jq;
  for (int n = n0; n < n1; ++n) {
    cp_async_wait<WKV_STAGES - 2>();
    __syncthreads();                   // record n landed; step n-1 done
    if (n + WKV_STAGES - 1 < n1) fetch(n + WKV_STAGES - 1);
    cp_async_commit();
    const Record& st = s.rec[(n - n0) % WKV_STAGES];
    float4 acc = kh ? f4(0.f) : ld4(&st.oi[t][jq]);
#pragma unroll 4
    for (int c = kh * CH; c < (kh + 1) * CH; c += 4) {
      const float4 rr = ld4(&st.rt[t][c]);
      acc = fma4(rr.x, ld4(&s.S[c][jq]), acc);
      acc = fma4(rr.y, ld4(&s.S[c + 1][jq]), acc);
      acc = fma4(rr.z, ld4(&s.S[c + 2][jq]), acc);
      acc = fma4(rr.w, ld4(&s.S[c + 3][jq]), acc);
    }
    if (KS > 1) {
      if (kh) at4(&s.part[t][jq]) = acc;
      __syncthreads();
      if (!kh) {
        const float4 q = at4(&s.part[t][jq]);
        acc = make_float4(acc.x + q.x, acc.y + q.y, acc.z + q.z, acc.w + q.w);
      }
    }
    const int tok = n * L + t;
    if (live_cols && tok < a.T) store4(op + tok * a.so[2], 0, a.hs - j0 - jq,
                                       a.vec, acc);
    __syncthreads();                   // every read of the old state done
    for (int x = tid; x < WKV_HS * (WKV_COLS / 4); x += NT) {
      const int c = x / (WKV_COLS / 4), j = x % (WKV_COLS / 4) * 4;
      at4(&s.S[c][j]) = fma4(st.a[c], at4(&s.S[c][j]), ld4(&st.ds[c][j]));
    }
  }
  if (seg + 1 < a.nseg) return;        // the last segment writes S_T
  __syncthreads();
  float* sp = a.s_out + (long long)bh * a.hs * a.hs;
  for (int i = tid; i < WKV_HS * WKV_COLS; i += NT) {
    const int c = i / WKV_COLS, jj = i % WKV_COLS;
    if (c < a.hs && j0 + jj < a.hs) sp[c * a.hs + j0 + jj] = s.S[c][jj];
  }
}

// The shared-memory limit is raised once a process for each kernel.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int L>
static cudaError_t launch(const WkvArgs& a, int BH, cudaStream_t stream) {
  static const cudaError_t intra_ok =
      allow_smem(wkv6_intra_kernel<L>, sizeof(IntraSmem<L>));
  static const cudaError_t carry_ok =
      allow_smem(wkv6_carry_kernel<L>, sizeof(CarrySmem<L>));
  if (intra_ok != cudaSuccess) return intra_ok;
  if (carry_ok != cudaSuccess) return carry_ok;
  wkv6_intra_kernel<L><<<dim3(a.nc, BH), WKV_THREADS, sizeof(IntraSmem<L>),
                         stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.nc == 1) return e;
  if (a.nseg > 1) {
    wkv6_span_kernel<L><<<dim3(WKV_HS * WKV_HS / WKV_THREADS, BH),
                          WKV_THREADS, 0, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const int blocks = BH * ((a.hs + WKV_COLS - 1) / WKV_COLS);
  wkv6_carry_kernel<L><<<dim3(blocks, a.nseg), carry_threads(L),
                         sizeof(CarrySmem<L>), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace repro_torch

// r, k, v, w (B, H, T, hs) f32 with element strides (b, h, t) for each in
// strides[0..11] and o's in strides[12..14] (every last stride 1), u (H,
// hs) f32 contiguous -> o and the final state s_out (B, H, hs, hs) f32
// contiguous, from a zero state; 1 <= hs <= 64.  The workspace holds
// ws_floats floats: B * H * ceil(T / L) * (2 L 64 + 64 64 + 64) when T > L
// (L = 16 for T <= 64, else 32), else none.
extern "C" int repro_wkv6_chunked(const void* r, const void* k, const void* v,
                                  const void* w, const void* u, void* o,
                                  void* s_out, void* workspace,
                                  const long long* strides,
                                  long long ws_floats, int B, int H, int T,
                                  int hs, void* stream) {
  using namespace repro_torch;
  if (B < 0 || H < 1 || T < 0 || hs < 1 || hs > WKV_HS)
    return (int)cudaErrorInvalidValue;
  const long long BH = (long long)B * H;
  if (BH > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH == 0) return (int)cudaGetLastError();
  if (T == 0)
    return (int)cudaMemsetAsync(s_out, 0, BH * hs * hs * sizeof(float), st);
  const int L = T <= 64 ? 16 : 32;
  WkvArgs a{};
  a.r = static_cast<const float*>(r);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.o = static_cast<float*>(o);
  a.s_out = static_cast<float*>(s_out);
  a.ws = static_cast<float*>(workspace);
  long long* dst[5] = {a.sr, a.sk, a.sv, a.sw, a.so};
  int vec = hs % 4 == 0;
  for (int i = 0; i < 15; ++i) {
    dst[i / 3][i % 3] = strides[i];
    vec &= strides[i] % 4 == 0;
  }
  const void* ptrs[6] = {r, k, v, w, o, s_out};
  for (const void* p : ptrs)
    vec &= reinterpret_cast<unsigned long long>(p) % 16 == 0;
  a.H = H;
  a.T = T;
  a.hs = hs;
  a.nc = (T + L - 1) / L;
  a.nseg = (a.nc + WKV_SEG - 1) / WKV_SEG;
  a.vec = vec;
  const long long need = BH * (a.nc * wkv_record(L) +
                               (a.nseg - 1LL) * WKV_HS * WKV_HS);
  if (a.nc > 1 && (workspace == nullptr || ws_floats < need ||
                   reinterpret_cast<unsigned long long>(workspace) % 16))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = L == 16 ? launch<16>(a, (int)BH, st)
                                : launch<32>(a, (int)BH, st);
  return (int)e;
}
