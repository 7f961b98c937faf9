// Fused AdamW update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_adamw.adamw_update
// (src/repro/kernels/fused_adamw.py): one pass that reads p, g, m, v and
// writes p', m', v' over a flat (N,) f32 leaf, with the hyperparameters
// (lr, b1, b2, eps, wd, bc1, bc2, 0) read from an (8,) f32 device array, as
// the TPU kernel's (1, 8) operand: the schedule's lr and the bias
// corrections are device values, so no launch waits on the host.
//
// Arithmetic: the TPU kernel's order of operations, each rounded on its
// own (__fmul_rn etc., so nvcc does not contract a multiply and an add
// into one FMA):
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + ((1 - b2) * g) * g
//   p' = p - lr * ((m' / bc1) / (sqrt(v' / bc2) + eps) + wd * p)
// with 1 - b1 and 1 - b2 taken in f32 from the f32 b1, b2.
//
// What bounds it on the H100: bytes, 7 streams of 4 bytes per element
// (28 N bytes; about 10 operations per element are far below the f32
// rate).  Design: a grid-stride loop over float4 groups (16-byte loads
// and stores, neighbouring lanes on neighbouring addresses) and a scalar
// tail, so any N is taken: the TPU kernel's (8, N / 8) tiling asserts
// (N / 8) % 2048 == 0 once N / 8 > 2048, and this kernel has no such
// condition.  The TPU grid walks blocks in order; here blocks are
// independent, which an elementwise update allows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int AW_THREADS = 256;
constexpr long long AW_MAX_BLOCKS = 132 * 16;

struct Hyper {
  float lr, b1, b2, eps, wd, bc1, bc2, c1, c2;
};

__device__ __forceinline__ void adamw_one(const Hyper& h, float p, float g,
                                          float m, float v, float& p1,
                                          float& m1, float& v1) {
  m1 = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.c1, g));
  v1 = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.c2, g), g));
  const float mh = __fdiv_rn(m1, h.bc1);
  const float vh = __fdiv_rn(v1, h.bc2);
  const float upd = __fadd_rn(__fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), h.eps)),
                              __fmul_rn(h.wd, p));
  p1 = __fsub_rn(p, __fmul_rn(h.lr, upd));
}

__global__ void __launch_bounds__(AW_THREADS) adamw_update_kernel(
    const float* __restrict__ hyper, const float* __restrict__ p,
    const float* __restrict__ g, const float* __restrict__ m,
    const float* __restrict__ v, float* __restrict__ p1,
    float* __restrict__ m1, float* __restrict__ v1, long long n,
    long long n4) {
  Hyper h;
  h.lr = hyper[0]; h.b1 = hyper[1]; h.b2 = hyper[2]; h.eps = hyper[3];
  h.wd = hyper[4]; h.bc1 = hyper[5]; h.bc2 = hyper[6];
  h.c1 = __fsub_rn(1.f, h.b1);
  h.c2 = __fsub_rn(1.f, h.b2);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = t; i < n4; i += stride) {
    const float4 pp = reinterpret_cast<const float4*>(p)[i];
    const float4 gg = reinterpret_cast<const float4*>(g)[i];
    const float4 mm = reinterpret_cast<const float4*>(m)[i];
    const float4 vv = reinterpret_cast<const float4*>(v)[i];
    float4 po, mo, vo;
    adamw_one(h, pp.x, gg.x, mm.x, vv.x, po.x, mo.x, vo.x);
    adamw_one(h, pp.y, gg.y, mm.y, vv.y, po.y, mo.y, vo.y);
    adamw_one(h, pp.z, gg.z, mm.z, vv.z, po.z, mo.z, vo.z);
    adamw_one(h, pp.w, gg.w, mm.w, vv.w, po.w, mo.w, vo.w);
    reinterpret_cast<float4*>(p1)[i] = po;
    reinterpret_cast<float4*>(m1)[i] = mo;
    reinterpret_cast<float4*>(v1)[i] = vo;
  }
  for (long long i = 4 * n4 + t; i < n; i += stride)
    adamw_one(h, p[i], g[i], m[i], v[i], p1[i], m1[i], v1[i]);
}

}  // namespace repro_torch

// hyper (8,) f32; p, g, m, v (n,) f32 -> p1, m1, v1 (n,) f32 (new buffers).
extern "C" int repro_adamw_update(const void* hyper, const void* p,
                                  const void* g, const void* m, const void* v,
                                  void* p1, void* m1, void* v1, long long n,
                                  void* stream) {
  using namespace repro_torch;
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const uintptr_t align = reinterpret_cast<uintptr_t>(p)
        | reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(m)
        | reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(p1)
        | reinterpret_cast<uintptr_t>(m1) | reinterpret_cast<uintptr_t>(v1);
    const long long n4 = align % 16 == 0 ? n / 4 : 0;
    long long blocks = ((n4 > 0 ? n4 : n) + AW_THREADS - 1) / AW_THREADS;
    if (blocks > AW_MAX_BLOCKS) blocks = AW_MAX_BLOCKS;
    adamw_update_kernel<<<(unsigned)blocks, AW_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(hyper), static_cast<const float*>(p),
        static_cast<const float*>(g), static_cast<const float*>(m),
        static_cast<const float*>(v), static_cast<float*>(p1),
        static_cast<float*>(m1), static_cast<float*>(v1), n, n4);
  }
  return (int)cudaGetLastError();
}
