// 1-bit (EF-signSGD) gradient compression for Hopper (sm_90a), paper Eq. 10.
//
// Replaces the Pallas TPU kernels grad_compress.onebit_quantize and
// grad_compress.onebit_dequantize (src/repro/kernels/grad_compress.py).
// Layout, as there: the flat gradient of N floats is viewed as (8, M),
// M = N / 8, row-major.  Bit j of packed[c] is the sign of g[j * M + c]
// (x >= 0 packs 1, so an exact zero dequantizes to +scale), and scale t is
// the mean |g| over the (8, block) tile of columns [t * block, (t+1) * block).
//
// What bounds them on the H100: bytes.  Quantize reads 4N bytes and writes
// N / 8 + 4N / (8 * block); dequantize reads N / 8 bytes (+ the scales) and
// writes 4N.  A few integer and float operations per byte are far below the
// card's rate, so both are memory passes at best.
//
// Design, and where it departs from the TPU kernels' structure:
// * Quantize: one CUDA block per scale tile (grid M / block).  Each thread
//   takes columns c = tile * block + t, t + 256, ...; for each it reads the
//   8 strided values g[j * M + c] (neighbouring threads read neighbouring
//   addresses in each of the 8 rows, so every load is coalesced), packs the
//   byte and adds |g| into a register.  The tile's sum is a fixed tree --
//   warp shuffles, then one warp over the 8 warp sums -- so the scales do
//   not depend on the order blocks run in (no float atomics).  Bytes equal
//   the plain version's exactly; scales differ from it in the last bits only
//   by summation order.
// * Dequantize takes R payloads at once, packed (R, M) and scales (R, M /
//   block), and writes (R, 8, M): the local payload (R = 1) and the P ranks'
//   gathered payloads (R = P) are one launch each, where the TPU code calls
//   the kernel once per rank.  One thread per (payload, column) reads one
//   byte and one scale and writes 8 strided floats, each row coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int GC_THREADS = 256;

__global__ void __launch_bounds__(GC_THREADS) onebit_quantize_kernel(
    const float* __restrict__ g, uint8_t* __restrict__ packed,
    float* __restrict__ scales, long long M, int block) {
  __shared__ float warp_sum[GC_THREADS / 32];
  const long long c0 = (long long)blockIdx.x * block;
  float acc = 0.f;
  for (int t = threadIdx.x; t < block; t += GC_THREADS) {
    const long long c = c0 + t;
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x = g[j * M + c];
      bits |= (unsigned)(x >= 0.f) << j;
      acc += fabsf(x);
    }
    packed[c] = (uint8_t)bits;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    float s = threadIdx.x < GC_THREADS / 32 ? warp_sum[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (threadIdx.x == 0) scales[blockIdx.x] = s / (8.f * (float)block);
  }
}

__global__ void __launch_bounds__(GC_THREADS) onebit_dequantize_kernel(
    const uint8_t* __restrict__ packed, const float* __restrict__ scales,
    float* __restrict__ out, long long M, int block) {
  const long long c = (long long)blockIdx.x * GC_THREADS + threadIdx.x;
  if (c >= M) return;
  const long long r = blockIdx.y;
  const unsigned bits = packed[r * M + c];
  const float s = scales[r * (M / block) + c / block];
  float* o = out + r * 8 * M + c;
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j * M] = (bits >> j) & 1u ? s : -s;
}

}  // namespace repro_torch

// g (8, M) f32 contiguous -> packed (M,) u8, scales (M / block,) f32.
// M % block == 0 (the wrapper checks).
extern "C" int repro_onebit_quantize(const void* g, void* packed,
                                     void* scales, long long M, int block,
                                     void* stream) {
  if (block <= 0 || M % block) return (int)cudaErrorInvalidValue;
  const long long nb = M / block;
  if (nb > 0)
    repro_torch::onebit_quantize_kernel<<<
        (unsigned)nb, repro_torch::GC_THREADS, 0,
        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(g), static_cast<uint8_t*>(packed),
        static_cast<float*>(scales), M, block);
  return (int)cudaGetLastError();
}

// packed (R, M) u8, scales (R, M / block) f32 -> out (R, 8, M) f32.
extern "C" int repro_onebit_dequantize(const void* packed, const void* scales,
                                       void* out, int R, long long M,
                                       int block, void* stream) {
  if (block <= 0 || M % block || R > 65535) return (int)cudaErrorInvalidValue;
  const long long gx = (M + repro_torch::GC_THREADS - 1) / repro_torch::GC_THREADS;
  if (gx > 0 && R > 0)
    repro_torch::onebit_dequantize_kernel<<<
        dim3((unsigned)gx, (unsigned)R), repro_torch::GC_THREADS, 0,
        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed),
        static_cast<const float*>(scales), static_cast<float*>(out), M,
        block);
  return (int)cudaGetLastError();
}
