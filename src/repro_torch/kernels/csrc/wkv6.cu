// Chunked WKV6 for Hopper (sm_90a): the RWKV-6 time-mix recurrence.
//
// Replaces the Pallas TPU kernel wkv6.wkv6_chunked
// (src/repro/kernels/wkv6.py): over float32 (B, H, T, hs) streams r, k, v,
// w (decay in (0, 1)) and a (H, hs) bonus u, from a zero state,
//   o_t = r_t (S_{t-1} + diag(u) k_t v_t^T),
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,
// computed a chunk of C tokens at a time (T % C == 0).  Beyond the TPU
// kernel it also writes the final state S_T (B, H, hs, hs) f32, which the
// serving prefill scatters into the request's slot.  The math is
// src/repro/models/ssm.py's _wkv6_chunked: with cum_t = sum_{s<=t} log w_s
// (per channel, <= 0),
//   o_t = sum_{s<t} (sum_c r_tc exp(cum_{t-1,c} - cum_sc) k_sc) v_s
//       + (r_t * exp(cum_{t-1})) S + (sum_c r_tc u_c k_tc) v_t,
//   S'  = diag(exp(cum_C)) S + sum_s (k_s * exp(cum_C - cum_s)) v_s^T;
// every exponent is <= 0, so w = 1e-6 underflows to its true ~0 instead of
// overflowing.
//
// What bounds it on the H100: at the serving shapes, bytes (read r, k, v,
// w once, write o and S_T once: a prefill of 48 tokens over 32 heads of 64
// moves 2.5 MB); at long T the float32 arithmetic (~24 operations per
// token and channel at C = 32, the C * C * hs / 2 pairwise exps of the
// intra-chunk term among them: exp(-cum_s) alone would overflow, so they
// cannot be factored) comes level with the bytes.
//
// Design.  The TPU kernel carries the (hs, hs) state in VMEM across a
// sequential chunk axis of its grid and materialises a (C, C, hs) decay
// tensor: 256 KB at C = 32, hs = 64, more than a block's 227 KB of shared
// memory.  Here one block owns one (b, h) and loops over the chunks
// itself, the state (16 KB f32) resident in shared memory throughout; the
// decay factors are computed where they are used, never stored.  Per
// chunk: load the four (C, hs) tiles (coalesced, rows padded to hs + 1
// floats so a warp reading a column of a tile hits 32 banks); one thread
// per channel takes the running sum of log w; then M[t][s] = sum_c
// r_tc exp(min(cum_{t-1,c} - cum_sc, 0)) k_sc for s < t and the bonus
// sum_c r_tc u_c k_tc on the diagonal, beside r * exp(cum_{t-1}) and
// k * exp(cum_C - cum); then o = M v + (r * exp(cum_{t-1})) S, written
// straight to device memory, and last the state update, each thread
// owning (row c, column j) elements.  Sums run in a fixed order (no
// atomics), so the result is deterministic.  One block per (b, h) leaves
// most SMs idle at B * H = 32; splitting the hs value columns of S across
// blocks (each column of S is independent) is the next step for speed.
#include <cuda_runtime.h>
#include <math.h>

namespace repro_torch {

constexpr int WKV_THREADS = 512;
constexpr int WKV_MAX_HS = 64;
constexpr int WKV_MAX_CHUNK = 64;

// floats of dynamic shared memory: S, seven padded (C, hs + 1) tiles (rs,
// ks, vs, cum, cprev, rdec, kdec), M: 78.7 KB at hs = 64, C = 32, and
// 149 KB at the limits hs = C = 64
inline size_t wkv6_smem_floats(int hs, int C) {
  return (size_t)hs * hs + 7 * (size_t)C * (hs + 1) + (size_t)C * C;
}

__global__ void __launch_bounds__(WKV_THREADS) wkv6_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, float* __restrict__ o,
    float* __restrict__ s_out, int H, int T, int hs, int C) {
  extern __shared__ float smem[];
  const int ld = hs + 1;
  float* S = smem;                     // (hs, hs): S[c * hs + j]
  float* rs = S + hs * hs;             // the (C, ld) tiles
  float* ks = rs + C * ld;
  float* vs = ks + C * ld;
  float* cum = vs + C * ld;            // cum_t
  float* cprev = cum + C * ld;         // w, then cum_{t-1}
  float* rdec = cprev + C * ld;        // r * exp(cum_{t-1})
  float* kdec = rdec + C * ld;         // k * exp(cum_C - cum)
  float* M = kdec + C * ld;            // (C, C)

  const int bh = blockIdx.x;           // b * H + h
  const float* uh = u + (long long)(bh % H) * hs;
  const long long base = (long long)bh * T * hs;
  const int tid = threadIdx.x;
  for (int i = tid; i < hs * hs; i += blockDim.x) S[i] = 0.f;

  for (int t0 = 0; t0 < T; t0 += C) {
    const long long off = base + (long long)t0 * hs;
    for (int i = tid; i < C * hs; i += blockDim.x) {
      const int t = i / hs, c = i - t * hs;
      rs[t * ld + c] = r[off + i];
      ks[t * ld + c] = k[off + i];
      vs[t * ld + c] = v[off + i];
      cprev[t * ld + c] = w[off + i];
    }
    __syncthreads();
    // running sum of log w per channel (1e-30: a subnormal floor may
    // flush to zero -> log(0))
    for (int c = tid; c < hs; c += blockDim.x) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        const float lw = logf(fmaxf(cprev[t * ld + c], 1e-30f));
        acc += lw;
        cum[t * ld + c] = acc;
        cprev[t * ld + c] = acc - lw;
      }
    }
    __syncthreads();
    const float* cum_c = cum + (C - 1) * ld;
    for (int i = tid; i < C * C; i += blockDim.x) {
      const int t = i / C, s = i - t * C;
      const float* rt = rs + t * ld;
      float acc = 0.f;
      if (s < t) {
        const float* cp = cprev + t * ld;
        const float* cs = cum + s * ld;
        const float* kk = ks + s * ld;
        for (int c = 0; c < hs; ++c)
          acc += rt[c] * expf(fminf(cp[c] - cs[c], 0.f)) * kk[c];
      } else if (s == t) {
        const float* kk = ks + t * ld;
        for (int c = 0; c < hs; ++c) acc += rt[c] * uh[c] * kk[c];
      }
      M[i] = acc;
    }
    for (int i = tid; i < C * hs; i += blockDim.x) {
      const int t = i / hs, c = i - t * hs;
      rdec[t * ld + c] = rs[t * ld + c] * expf(cprev[t * ld + c]);
      kdec[t * ld + c] = ks[t * ld + c] * expf(cum_c[c] - cum[t * ld + c]);
    }
    __syncthreads();
    for (int i = tid; i < C * hs; i += blockDim.x) {
      const int t = i / hs, j = i - t * hs;
      float intra = 0.f, cross = 0.f;
      for (int s = 0; s <= t; ++s) intra += M[t * C + s] * vs[s * ld + j];
      for (int c = 0; c < hs; ++c) cross += rdec[t * ld + c] * S[c * hs + j];
      o[off + i] = intra + cross;
    }
    __syncthreads();                   // every o read the old state
    for (int i = tid; i < hs * hs; i += blockDim.x) {
      const int c = i / hs, j = i - c * hs;
      float acc = 0.f;
      for (int s = 0; s < C; ++s) acc += kdec[s * ld + c] * vs[s * ld + j];
      S[i] = expf(cum_c[c]) * S[i] + acc;
    }
    __syncthreads();                   // before the next chunk's loads
  }
  float* so = s_out + (long long)bh * hs * hs;
  for (int i = tid; i < hs * hs; i += blockDim.x) so[i] = S[i];
}

}  // namespace repro_torch

// r, k, v, w (B, H, T, hs) f32 contiguous, u (H, hs) f32 -> o (B, H, T, hs)
// f32 and the final state (B, H, hs, hs) f32, from a zero state;
// 1 <= hs <= 64, 1 <= chunk <= 64, T % chunk == 0.
extern "C" int repro_wkv6_chunked(const void* r, const void* k, const void* v,
                                  const void* w, const void* u, void* o,
                                  void* s_out, int B, int H, int T, int hs,
                                  int chunk, void* stream) {
  using namespace repro_torch;
  if (B < 0 || H < 1 || T < 0 || hs < 1 || hs > WKV_MAX_HS || chunk < 1 ||
      chunk > WKV_MAX_CHUNK || T % chunk)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * H;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaGetLastError();
  const size_t smem = wkv6_smem_floats(hs, chunk) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      wkv6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  wkv6_kernel<<<(unsigned)blocks, WKV_THREADS, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(o),
      static_cast<float*>(s_out), H, T, hs, chunk);
  return (int)cudaGetLastError();
}
