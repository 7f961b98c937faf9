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
// duplicates summed in input order.  The TPU kernel keeps the whole output
// in VMEM and adds the rows one after another in a sequential fori_loop;
// the card has no sequential grid, and float atomics would add in another
// order on every run.  What bounds it on the H100 is bytes: the output is
// written whole (n_rows * D floats, 49 MB for the (192,404, 64) cf_user
// gradient) while x is a few rows, so the function is one zero-fill's
// worth of stores.  One kernel does it all, in one launch, with no sort:
// * Slabs.  Each block sums one contiguous flat slab of 4096 floats of
//   the row-major output in registers: each of its 256 threads owns 16
//   floats, as 4 float4 spaced 256 float4 apart, so every warp's stores
//   cover 512 contiguous bytes.  A slab need not hold whole rows (a row
//   may straddle two slabs; each adds its part), so there is no column
//   band for a wide D.  Block b takes slab n_slabs - 1 - b: the blocks
//   start in index order, and callers put the sentinel dump row last
//   (embeddings/update.scatter_rows pads with n_rows), so the slab with
//   the most hits starts first instead of stretching the tail.
// * Walk the ids.  The block takes idx in input order, 256 ids a chunk;
//   each thread tests one id against the slab's rows, and one barrier
//   (__syncthreads_or) tells whether any lands there: at the training
//   path's 32 ids nearly every slab stops at that and goes straight to
//   its stores.  Where some do, a ballot and a prefix over the warps'
//   counts compact the chunk's hits into shared memory in input order.
// * Stage, then add in order.  The hits' parts of x inside the slab are
//   copied into shared memory by all threads at once, up to 4096 floats
//   a group, so their loads overlap; then every thread walks the group's
//   hits in input order and adds the staged values to the floats it owns
//   with IEEE adds (__fadd_rn) from 0.f.  Each output float is one
//   thread's sequential sum in input order, the TPU kernel's loop
//   restricted to the slab: its result bit for bit.  Ids outside [0,
//   n_rows) never land in a slab and are skipped.
//   (Loaded inside the walk instead, each hit's x load would wait on the
//   previous add: at the training path's shape, 16 of whose 32 ids are
//   the sentinel, that chain alone outlasts the other slabs' stores.)
// * Write once.  A slab is stored once with 16-byte stores (the output
//   base must be 16-byte aligned; the wrapper allocates it), scalar
//   stores only for the last slab's tail: the zero-fill and the sums share
//   the single write.  x is read once, idx once a block (~3,000 blocks x
//   128 bytes from L2 at the path's shape, next to 49 MB).
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int GR_WARPS = 8;          // rows per 256-thread block
constexpr int SA_THREADS = 256;      // threads a slab
constexpr int SA_VECS = 4;           // float4 a thread
constexpr int SA_SLAB = SA_THREADS * SA_VECS * 4;   // floats a slab
constexpr int SA_STAGE = 4096;       // floats of x staged a group of hits

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

__global__ void __launch_bounds__(SA_THREADS) scatter_add_rows_kernel(
    const float* __restrict__ x, const int* __restrict__ idx,
    float* __restrict__ out, long long n, int D, long long count) {
  // a chunk's hits in input order: [lo, hi) of the slab (slab-relative
  // floats) and where their values start in x
  __shared__ int hit_lo[SA_THREADS], hit_hi[SA_THREADS];
  __shared__ long long hit_x[SA_THREADS];
  __shared__ int warp_hits[SA_THREADS / 32];
  __shared__ float stage[SA_STAGE];     // the hits' values, a group
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long f0 = (long long)(gridDim.x - 1 - blockIdx.x) * SA_SLAB;
  const long long f1 = min(f0 + SA_SLAB, count);
  const long long row_lo = f0 / D, row_hi = (f1 + D - 1) / D;
  const int W = (int)min((long long)D, (long long)SA_SLAB);  // a hit's part
  const int G = SA_STAGE / W;                                // hits a group
  float acc[SA_VECS][4];
#pragma unroll
  for (int u = 0; u < SA_VECS; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[u][c] = 0.f;

  for (long long base = 0; base < n; base += SA_THREADS) {
    const long long i = base + tid;
    const int id = i < n ? idx[i] : -1;
    const bool hit = id >= row_lo && id < row_hi;
    if (!__syncthreads_or(hit)) continue;   // no id of the chunk lands here
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < SA_THREADS / 32; ++w) {
      before += w < warp ? warp_hits[w] : 0;
      total += warp_hits[w];
    }
    if (hit) {
      const int at = before + __popc(ballot & ((1u << lane) - 1u));
      const long long r0 = (long long)id * D;
      const long long lo = max(r0, f0);
      hit_lo[at] = (int)(lo - f0);
      hit_hi[at] = (int)(min(r0 + D, f1) - f0);
      hit_x[at] = i * D + (lo - r0);
    }
    __syncthreads();
    for (int j0 = 0; j0 < total; j0 += G) {
      const int gn = min(G, total - j0);
      // every value of the group's hits into stage[q * W ...] at once
      for (int k = tid; k < gn * W; k += SA_THREADS) {
        const int q = j0 + k / W, o = k % W;
        if (o < hit_hi[q] - hit_lo[q]) stage[k] = x[hit_x[q] + o];
      }
      __syncthreads();
#pragma unroll 4
      for (int q = 0; q < gn; ++q) {         // in input order
        const int lo = hit_lo[j0 + q], hi = hit_hi[j0 + q];
#pragma unroll
        for (int u = 0; u < SA_VECS; ++u)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int e = 4 * (tid + u * SA_THREADS) + c;
            if (e >= lo && e < hi)
              acc[u][c] = __fadd_rn(acc[u][c], stage[q * W + e - lo]);
          }
      }
      __syncthreads();   // stage and the hit arrays are reused
    }
  }

#pragma unroll
  for (int u = 0; u < SA_VECS; ++u) {
    const long long e = f0 + 4LL * (tid + u * SA_THREADS);
    if (e + 4 <= f1) {
      *reinterpret_cast<float4*>(out + e) =
          make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (e + c < f1) out[e + c] = acc[u][c];
    }
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

// x (n, D) f32, idx (n,) int32 -> out (n_rows, D) f32, 16-byte aligned.
extern "C" int repro_scatter_add_rows(const void* x, const void* idx,
                                      void* out, long long n, int D,
                                      long long n_rows, void* stream) {
  using namespace repro_torch;
  const long long count = n_rows * (long long)D;
  if (n < 0 || D <= 0 || n_rows < 0
      || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long slabs = (count + SA_SLAB - 1) / SA_SLAB;
  if (slabs > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (count > 0)
    scatter_add_rows_kernel<<<(unsigned)slabs, SA_THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const int*>(idx),
        static_cast<float*>(out), n, D, count);
  return (int)cudaGetLastError();
}
