// Embedding row gather and exact segment-sum scatter-add for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels embedding_ops.gather_rows and
// embedding_ops.scatter_add_rows (src/repro/kernels/embedding_ops.py).
//
// gather_rows: out[i] = table[ids[i]].  A pure copy: what bounds it is
// bytes, 2 * n * D * itemsize (each requested row read once, each output
// row written once), independent of the table's size.  The TPU kernel
// DMAs one row per grid step from a scalar-prefetched id; here one warp
// copies one row with the widest aligned vector the row allows (16 bytes
// a lane when the row's bytes and both bases are 16-byte aligned, else 4,
// else 1), so it works on the bytes and takes any dtype.  Ids must lie in
// [0, V) as for the TPU kernel (callers clamp); a row whose id does not
// is written as zeros rather than read from outside the table.
//
// scatter_add_rows: out (n_rows, D) f32 from zeros, out[idx[i]] += x[i],
// duplicates summed in input order.  The TPU kernel keeps the output in
// VMEM and adds the rows one after another in a sequential fori_loop; the
// card has no sequential grid and float atomics would add in a different
// order on every run.  So the wrapper sorts idx stably (input order kept
// within each id) and this entry point launches two kernels: a zero-fill
// of the whole output, then one block per sorted position, of which only
// each segment's first does work: its threads walk D and add the
// segment's rows in input order from 0.f, with IEEE adds (__fadd_rn), and
// write the row once.  The sum is therefore the TPU kernel's, bit for
// bit.  Bound: bytes, the read of n * D floats plus the write of
// n_rows * D (the zero-fill of untouched rows dominates for a large table).
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int GR_WARPS = 8;          // rows per 256-thread block
constexpr int SA_THREADS = 128;      // threads over D per segment
constexpr int ZF_THREADS = 256;

template <typename V>
__global__ void __launch_bounds__(GR_WARPS * 32) gather_rows_kernel(
    const V* __restrict__ table, const int* __restrict__ ids,
    V* __restrict__ out, long long n, long long v_rows, long long row_vecs) {
  const long long row = (long long)blockIdx.x * GR_WARPS + (threadIdx.x >> 5);
  if (row >= n) return;
  const int lane = threadIdx.x & 31;
  const long long id = ids[row];
  V* dst = out + row * row_vecs;
  if (id < 0 || id >= v_rows) {
    for (long long c = lane; c < row_vecs; c += 32) dst[c] = V{};
    return;
  }
  const V* src = table + id * row_vecs;
  for (long long c = lane; c < row_vecs; c += 32) dst[c] = src[c];
}

template <typename V>
static void launch_gather(const void* table, const void* ids, void* out,
                          long long n, long long v_rows, long long row_bytes,
                          cudaStream_t stream) {
  const long long blocks = (n + GR_WARPS - 1) / GR_WARPS;
  gather_rows_kernel<V><<<(unsigned)blocks, GR_WARPS * 32, 0, stream>>>(
      static_cast<const V*>(table), static_cast<const int*>(ids),
      static_cast<V*>(out), n, v_rows, row_bytes / (long long)sizeof(V));
}

__global__ void __launch_bounds__(ZF_THREADS) zero_fill_kernel(
    float4* __restrict__ out4, long long n4, float* __restrict__ out,
    long long count) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = t; i < n4; i += stride)
    out4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long i = 4 * n4 + t; i < count; i += stride) out[i] = 0.f;
}

__global__ void __launch_bounds__(SA_THREADS) segment_sum_kernel(
    const float* __restrict__ x, const int* __restrict__ sorted_idx,
    const long long* __restrict__ perm, float* __restrict__ out,
    long long n, int D, long long n_rows) {
  const long long i = blockIdx.x;                // sorted position
  const int row = sorted_idx[i];
  if (i > 0 && sorted_idx[i - 1] == row) return;  // not its segment's first
  if (row < 0 || row >= n_rows) return;
  long long end = i + 1;
  while (end < n && sorted_idx[end] == row) ++end;
  for (int d = threadIdx.x; d < D; d += SA_THREADS) {
    float s = 0.f;
    for (long long j = i; j < end; ++j)
      s = __fadd_rn(s, x[perm[j] * D + d]);
    out[(long long)row * D + d] = s;
  }
}

}  // namespace repro_torch

// table (v_rows, row_bytes) bytes, ids (n,) int32 -> out (n, row_bytes).
extern "C" int repro_gather_rows(const void* table, const void* ids,
                                 void* out, long long n, long long v_rows,
                                 long long row_bytes, void* stream) {
  using namespace repro_torch;
  if (n < 0 || v_rows < 0 || row_bytes <= 0
      || (n + GR_WARPS - 1) / GR_WARPS > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    const uintptr_t align = reinterpret_cast<uintptr_t>(table)
        | reinterpret_cast<uintptr_t>(out) | (uintptr_t)row_bytes;
    if (align % 16 == 0)
      launch_gather<uint4>(table, ids, out, n, v_rows, row_bytes, s);
    else if (align % 4 == 0)
      launch_gather<unsigned int>(table, ids, out, n, v_rows, row_bytes, s);
    else
      launch_gather<unsigned char>(table, ids, out, n, v_rows, row_bytes, s);
  }
  return (int)cudaGetLastError();
}

// x (n, D) f32; sorted_idx (n,) int32, the stably sorted target rows, and
// perm (n,) int64 with sorted_idx[j] == idx[perm[j]] -> out (n_rows, D).
extern "C" int repro_scatter_add_rows(const void* x, const void* sorted_idx,
                                      const void* perm, void* out,
                                      long long n, int D, long long n_rows,
                                      void* stream) {
  using namespace repro_torch;
  if (n < 0 || D <= 0 || n_rows < 0 || n > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const long long count = n_rows * (long long)D;
  if (count > 0) {
    const long long n4 =
        reinterpret_cast<uintptr_t>(out) % 16 == 0 ? count / 4 : 0;
    long long blocks = (count / 4 + ZF_THREADS - 1) / ZF_THREADS;
    blocks = blocks < 1 ? 1 : (blocks > 8192 ? 8192 : blocks);
    zero_fill_kernel<<<(unsigned)blocks, ZF_THREADS, 0, s>>>(
        static_cast<float4*>(out), n4, static_cast<float*>(out), count);
  }
  if (n > 0 && count > 0)
    segment_sum_kernel<<<(unsigned)n, SA_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(sorted_idx),
        static_cast<const long long*>(perm), static_cast<float*>(out), n, D,
        n_rows);
  return (int)cudaGetLastError();
}
