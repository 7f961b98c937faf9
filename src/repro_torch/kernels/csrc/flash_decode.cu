// Length-aware GQA flash-decode for Hopper (sm_90a): dense, int8, paged and
// paged int8 caches, split over the KV range ("flash-decoding").
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
// 2 * live * Hk * 4 bytes of scales in int8) and does ~4 FLOP per byte per
// query row, far below the ~295 FLOP/byte at which the tensor cores would
// bind.  At a serving step that is a few MB, so what the card needs is
// enough bytes in flight at once, spread over enough SMs, and the fewest
// dependent round trips to device memory before the last byte arrives.
//
// Design: two kernels a call.
// * flash_decode_split_kernel, grid (S / 64, Hk, B), 4 warps a block.  A
//   block owns one 64-key span ("split") of one (slot, KV head).  It reads
//   lengths[b] and q_lens[b], computes the slot's live key range [lo, hi)
//   (hi = min(lengths + q_lens - 1, S); lo = max(lengths - window, 0) for
//   the linear window band, else 0: the clamp at S also covers the free
//   serving slots, whose lengths keep counting past S) and returns at once
//   when its span holds no live key; its query rows (and, paged, its
//   span's table entries) are requested in the same round trip.  Every
//   live block's K and V rows are then requested together, 16-byte
//   cp.async copies into shared memory in two commit groups (K, then V),
//   so the whole step's live bytes are in flight across the card at once;
//   the V copies land while K is scored.
//   The number of splits comes from S on the host, never from lengths.
// * Every query row of the KV head is scored against the staged tile: the
//   TPU kernel's folded Sq * G rows (_prep_q), row r being draft j = r / G
//   of query head hk * G + r % G, up to 8 rows at a time.  K/V are read
//   from device memory once per (slot, KV head, split) whatever G and Sq
//   are.  A thread scores one key against 4 of the rows, reading the
//   staged row 16 bytes at a time (rows padded by 16 bytes, so a load
//   phase is free of bank conflicts; q is a broadcast read): no shuffles,
//   and 4 independent FMA chains.  A warp then takes the softmax of one
//   row over the span, and the P.V product splits the span's keys over
//   the 4 warps, summed in a fixed order through shared memory.
// * Each block writes its rows' partial (m, l, acc) in float32 to a
//   workspace the wrapper allocates.  flash_decode_merge_kernel, one
//   thread an output element, reads the partials of the slot's live splits
//   only (found from the same [lo, hi)), 8 splits' loads at a time,
//   rescales each by exp(m_i - max m), floors the sum l at 1e-30 and
//   writes o in q's type.  It is launched as a programmatic dependent of
//   the split kernel, so its launch overlaps the split kernel's run.  A
//   slot whose live keys lie in one span (every slot of a context up to
//   64 keys) skips the merge: that span's block writes o itself.  An
//   empty split or masked row contributes (NEG_INF, 0, 0), exactly
//   nothing; a row with no live key (len == 0, j >= q_len) comes out as
//   exact zeros.
// * Paged: virtual position p is row p % bs of physical block
//   tables[b, p / bs]; a block copies only the table entries its span
//   covers (4 for 64 keys of bs = 16) into shared memory.  No key outside
//   [lo, hi) is read, so a dead entry's null block 0 is never read.
// * int8: s = (q . k_q) * k_s * scale, and the probability is multiplied
//   by v_s only after it has entered the row sum l, as in the TPU kernel's
//   _decode_kernel; a span's scales are staged beside its rows.
// * Masks, per row j with eff = lengths + j (the causal intra-draft mask):
//   linear: pos < eff, and pos > eff - 1 - window when windowed; ring:
//   pos < min(eff, S) and floor_mod(eff - 1 - pos, S) < window -- a floor
//   modulo of a value that can be negative, where C++ % truncates; and the
//   draft cap j < q_lens.  A masked key's probability is 0.
// * Every tensor is read through its strides: a layer's view of the
//   stacked (L, B, S, Hk, D) cache or (L, N, bs, Hk, D) pool is passed as
//   it is.  q and o are float32 or bf16; K/V are q's type or int8; scores,
//   softmax and the output accumulate in float32; the scale multiplies q.k
//   after the dot, as on the TPU.
#include "online_softmax.cuh"

namespace repro_torch {

constexpr int FD_SPLIT = 64;  // keys a split: one block's span
constexpr int FD_WARPS = 4;
constexpr int FD_THREADS = FD_WARPS * 32;
constexpr int FD_ROWS = 8;    // query rows scored against a tile at once

__device__ __forceinline__ int floor_mod(int x, int n) {
  return ((x % n) + n) % n;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Programmatic dependent launch: the split kernel lets the merge kernel be
// scheduled while it runs, and the merge waits here for its writes.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Everything a launch needs, passed to both kernels by value.  Strides are
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
  float* ws;          // partials: acc (parts, D), then (m, l) (parts, 2)
  int B, Sq, H, Hk;
  int S;       // positions (dense) or virtual positions nb * bs (paged)
  int bs;      // paged: rows per block
  int nsplit;  // ceil(S / FD_SPLIT)
  long long sq[3], so[3], sk[3], sv[3], sks[3], svs[3];
  long long st;  // paged: table row stride
  float scale;
  int window, ring;
};

// The slot's live key range [lo, hi): every key some live row may attend.
struct LiveRange {
  int length, q_len, lo, hi;
  __device__ __forceinline__ LiveRange(const DecodeArgs& a, int b) {
    length = a.lengths[b];
    q_len = a.q_lens != nullptr ? a.q_lens[b] : a.Sq;
    hi = max(min(length + q_len - 1, a.S), 0);  // the last row's length
    lo = (a.window > 0 && !a.ring) ? max(length - a.window, 0) : 0;
  }
};

// Partial index of (slot b, KV head hk, split sp, row r); a partial is D
// floats of acc at ws + part * D and its (m, l) at ml_of(a) + 2 * part.
__device__ __forceinline__ long long part_of(const DecodeArgs& a, int b,
                                             int hk, int sp, int r) {
  return ((static_cast<long long>(b) * a.Hk + hk) * a.nsplit + sp) *
             (a.Sq * (a.H / a.Hk)) + r;
}

template <int D>
__device__ __forceinline__ float* ml_of(const DecodeArgs& a) {
  return a.ws + part_of(a, a.B, 0, 0, 0) * D;
}

// The split kernel's shared memory, in bytes from the start: the K rows of
// the span (D elements of V each, KROW bytes apart) and its V rows
// (packed), the rows' q in float32, their scores and then probabilities,
// the 4 warps' P.V sums, the span's int8 scales, the rows' (m, l) and the
// span's block-table entries.
template <typename V, int D>
struct SplitSmem {
  static constexpr int ROW = D * static_cast<int>(sizeof(V));
  static constexpr int KROW = ROW + 16;
  static constexpr int K = 0;
  static constexpr int VV = K + FD_SPLIT * KROW;
  static constexpr int Q = VV + FD_SPLIT * ROW;
  static constexpr int SC = Q + FD_ROWS * D * 4;
  static constexpr int RED = SC + FD_ROWS * FD_SPLIT * 4;
  static constexpr int KS = RED + FD_WARPS * FD_ROWS * D * 4;
  static constexpr int VS = KS + FD_SPLIT * 4;
  static constexpr int ML = VS + FD_SPLIT * 4;
  static constexpr int TBL = ML + 2 * FD_ROWS * 4;
  static constexpr int BYTES = TBL + (FD_SPLIT + 4) * 4;
  // blocks an SM for __launch_bounds__: as many as the 227 KB of shared
  // memory hold, at most 5, so a thread may use 65536 / (128 * BLOCKS)
  // registers, 96 or more (80, at 6 blocks, spills some bodies)
  static constexpr int BLOCKS =
      232448 / BYTES < 5 ? 232448 / BYTES : 5;
};

// N consecutive elements of type E read as one vector load (the address
// is aligned to the pack's size) and widened to float.
template <typename E, int N>
struct alignas(N * sizeof(E)) Pack {
  E e[N];
  __device__ __forceinline__ void to_floats(float* x) const {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = to_float(e[i]);
  }
};

template <typename E, int N>
__device__ __forceinline__ Pack<E, N> load_pack(const void* p) {
  return *reinterpret_cast<const Pack<E, N>*>(p);
}

// A 16-byte chunk of a K row as floats, widened from V.
template <typename V>
struct Chunk {
  static constexpr int N = 16 / static_cast<int>(sizeof(V));
  float x[N];
  __device__ __forceinline__ void load(const unsigned char* p) {
    load_pack<V, N>(p).to_floats(x);
  }
};

// The 16-byte chunks of up to FD_ROWS query rows (rows r0 .. r0 + nr of
// the KV head hk: draft j = r / G of head hk * G + r % G), QPT a thread,
// read into registers first and stored to shared memory as float later.
template <typename T, int D>
struct QRows {
  static constexpr int N = 16 / static_cast<int>(sizeof(T));  // a chunk
  static constexpr int QC = D / N;                             // a row
  static constexpr int QPT = (FD_ROWS * QC + FD_THREADS - 1) / FD_THREADS;
  Pack<T, N> raw[QPT];

  __device__ __forceinline__ void load(const DecodeArgs& a, int b, int hk,
                                       int r0, int nr) {
    const int G = a.H / a.Hk;
    const T* q = static_cast<const T*>(a.q);
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int c = threadIdx.x + i * FD_THREADS;
      if (c < nr * QC) {
        const int r = r0 + c / QC, j = r / G, h = hk * G + r % G;
        raw[i] = load_pack<T, N>(q + b * a.sq[0] + j * a.sq[1] +
                                 h * a.sq[2] + (c % QC) * N);
      }
    }
  }

  __device__ __forceinline__ void store(float* qs, int nr) const {
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int c = threadIdx.x + i * FD_THREADS;
      if (c < nr * QC) raw[i].to_floats(qs + c * N);
    }
  }
};

template <typename T, typename V, bool PAGED, int D>
__global__ void __launch_bounds__(FD_THREADS, SplitSmem<V, D>::BLOCKS)
    flash_decode_split_kernel(const DecodeArgs a) {
  using L = SplitSmem<V, D>;
  constexpr bool QUANT = std::is_same<V, int8_t>::value;
  constexpr int CPR = L::ROW / 16;      // 16-byte chunks a row
  constexpr int RPT = FD_ROWS * FD_SPLIT / FD_THREADS;  // rows a scoring thread
  static_assert(RPT * FD_THREADS == FD_ROWS * FD_SPLIT, "rows a thread");
  constexpr int EPL = D / 32;           // output columns a lane (P.V)
  constexpr int KPL = FD_SPLIT / 32;    // keys a lane (softmax)
  extern __shared__ __align__(16) unsigned char fd_smem[];
  unsigned char* k_s = fd_smem + L::K;
  unsigned char* v_s = fd_smem + L::VV;
  float* qs = reinterpret_cast<float*>(fd_smem + L::Q);
  float* sc = reinterpret_cast<float*>(fd_smem + L::SC);
  float* red = reinterpret_cast<float*>(fd_smem + L::RED);
  float* ks_s = reinterpret_cast<float*>(fd_smem + L::KS);
  float* vs_s = reinterpret_cast<float*>(fd_smem + L::VS);
  float* m_s = reinterpret_cast<float*>(fd_smem + L::ML);
  float* l_s = m_s + FD_ROWS;
  int* tbl_s = reinterpret_cast<int*>(fd_smem + L::TBL);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hk, R = a.Sq * G, S = a.S, window = a.window;
  const bool ring = a.ring != 0;
  const int s0 = sp * FD_SPLIT;

  // first round trip: the first query rows, the span's block-table entries
  // (e0 .. e0 + n_ent: table reads, so harmless past the live range) and
  // the slot's lengths, all requested before any is used
  QRows<T, D> qr;
  qr.load(a, b, hk, 0, min(FD_ROWS, R));
  int e0 = 0, ent = 0;
  if constexpr (PAGED) {
    e0 = s0 / a.bs;
    const int n_ent = (min(s0 + FD_SPLIT, S) - 1) / a.bs - e0 + 1;
    if (tid < n_ent) ent = a.tables[b * a.st + e0 + tid];
  }
  const LiveRange lr(a, b);
  const int k_lo = max(lr.lo, s0) - s0;             // live keys of the span
  const int k_hi = min(lr.hi, s0 + FD_SPLIT) - s0;
  if (k_lo >= k_hi) return;  // block-uniform, before any barrier
  launch_dependents();
  const bool alone = lr.lo >= s0 && lr.hi <= s0 + FD_SPLIT;  // only live span
  qr.store(qs, min(FD_ROWS, R));
  if constexpr (PAGED) {
    if (tid <= FD_SPLIT) tbl_s[tid] = ent;  // n_ent <= FD_SPLIT + 1
    __syncthreads();
  }

  // where position pos's row starts in a tensor of strides st
  auto at = [&](int pos, const long long* st) -> long long {
    if constexpr (PAGED)
      return static_cast<long long>(tbl_s[pos / a.bs - e0]) * st[0] +
             static_cast<long long>(pos % a.bs) * st[1];
    else
      return static_cast<long long>(b) * st[0] +
             static_cast<long long>(pos) * st[1];
  };

  // request every live K row of the span, then every V row
  const unsigned char* kg = static_cast<const unsigned char*>(a.k);
  const unsigned char* vg = static_cast<const unsigned char*>(a.v);
  const long long kh = hk * a.sk[2] * sizeof(V), vh = hk * a.sv[2] * sizeof(V);
  const int nchunks = (k_hi - k_lo) * CPR;
  for (int c = tid; c < nchunks; c += FD_THREADS) {
    const int kk = k_lo + c / CPR, off = (c % CPR) * 16;
    cp_async16(k_s + kk * L::KROW + off,
               kg + at(s0 + kk, a.sk) * sizeof(V) + kh + off);
  }
  cp_async_commit();
  for (int c = tid; c < nchunks; c += FD_THREADS) {
    const int kk = k_lo + c / CPR, off = (c % CPR) * 16;
    cp_async16(v_s + kk * L::ROW + off,
               vg + at(s0 + kk, a.sv) * sizeof(V) + vh + off);
  }
  cp_async_commit();
  if constexpr (QUANT) {
    for (int kk = k_lo + tid; kk < k_hi; kk += FD_THREADS) {
      ks_s[kk] = a.ks[at(s0 + kk, a.sks) + hk * a.sks[2]];
      vs_s[kk] = a.vs[at(s0 + kk, a.svs) + hk * a.svs[2]];
    }
  }

  for (int r0 = 0; r0 < R; r0 += FD_ROWS) {
    const int nr = min(FD_ROWS, R - r0);
    if (r0 > 0) {  // the first rows are in qs already
      __syncthreads();  // the previous rows are done with qs, sc, red, m_s
      qr.load(a, b, hk, r0, nr);
      qr.store(qs, nr);
    }
    cp_async_wait<1>();  // this thread's K copies (a no-op after the first)
    __syncthreads();

    // scores: thread t takes key t % 64 against RPT rows of the chunk,
    // (t / 64) * RPT on, walking the key's row 16 bytes at a time; the
    // rows' q is a broadcast read, and K rows sit KROW bytes apart, so the
    // 8 lanes of a 16-byte load phase hit distinct banks
    {
      const int kk = tid % FD_SPLIT, rg = tid / FD_SPLIT * RPT;
      if (kk >= k_lo && kk < k_hi && rg < nr) {
        float s[RPT];
#pragma unroll
        for (int u = 0; u < RPT; ++u) s[u] = 0.f;
#pragma unroll 2
        for (int c = 0; c < CPR; ++c) {
          Chunk<V> ch;
          ch.load(k_s + kk * L::KROW + c * 16);
#pragma unroll
          for (int u = 0; u < RPT; ++u) {
            if (rg + u < nr) {
              const float* qrow = qs + (rg + u) * D + c * Chunk<V>::N;
#pragma unroll
              for (int e = 0; e < Chunk<V>::N; e += 4) {
                const float4 qv = *reinterpret_cast<const float4*>(qrow + e);
                s[u] += qv.x * ch.x[e] + qv.y * ch.x[e + 1] +
                        qv.z * ch.x[e + 2] + qv.w * ch.x[e + 3];
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < RPT; ++u) {
          if (rg + u < nr) {
            if constexpr (QUANT) s[u] = s[u] * ks_s[kk] * a.scale;
            else s[u] *= a.scale;
            sc[(rg + u) * FD_SPLIT + kk] = s[u];
          }
        }
      }
    }
    __syncthreads();

    // softmax of each row over the span: one warp a row, KPL keys a lane
    for (int rr = warp; rr < nr; rr += FD_WARPS) {
      const int j = (r0 + rr) / G, eff = lr.length + j;
      const bool row_live = j < lr.q_len;
      bool ok[KPL];
      float s[KPL], mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const int kk = lane + 32 * i, pos = s0 + kk;
        ok[i] = row_live && kk >= k_lo && kk < k_hi &&
                (ring ? pos < min(eff, S) &&
                            floor_mod(eff - 1 - pos, S) < window
                      : pos < eff && (window <= 0 || pos > eff - 1 - window));
        s[i] = ok[i] ? sc[rr * FD_SPLIT + kk] : NEG_INF;
        mx = fmaxf(mx, s[i]);
      }
      const float m = warp_max(mx);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        s[i] = ok[i] ? expf(s[i] - m) : 0.f;
        psum += s[i];
      }
      const float l = warp_sum(psum);
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const int kk = lane + 32 * i;
        float p = s[i];
        if constexpr (QUANT) p = ok[i] ? p * vs_s[kk] : 0.f;
        sc[rr * FD_SPLIT + kk] = p;
      }
      if (lane == 0) {
        m_s[rr] = m;
        l_s[rr] = l;
      }
    }
    cp_async_wait<0>();  // this thread's V copies
    __syncthreads();

    // P.V: warp w takes the span's keys w, w + 4, ...; lane owns EPL
    // columns; PR rows a pass (V is re-read from shared memory per pass)
    constexpr int PR = 4;
    for (int g0 = 0; g0 < nr; g0 += PR) {
      float acc[PR][EPL];
#pragma unroll
      for (int u = 0; u < PR; ++u)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[u][e] = 0.f;
#pragma unroll 2
      for (int kk = k_lo + warp; kk < k_hi; kk += FD_WARPS) {
        float vf[EPL];
        load_pack<V, EPL>(v_s + kk * L::ROW + lane * EPL * sizeof(V))
            .to_floats(vf);
#pragma unroll
        for (int u = 0; u < PR; ++u) {
          if (g0 + u < nr) {
            const float p = sc[(g0 + u) * FD_SPLIT + kk];
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[u][e] += p * vf[e];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < PR; ++u)
        if (g0 + u < nr)
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            red[(warp * FD_ROWS + g0 + u) * D + lane * EPL + e] = acc[u][e];
    }
    __syncthreads();

    // the warps' sums in a fixed order: the block's partials, or, when
    // the span is the slot's only live one, o itself (what the merge would
    // write from this one partial: acc / max(l, 1e-30))
    const long long part0 = part_of(a, b, hk, sp, r0);
    for (int i = tid; i < nr * D; i += FD_THREADS) {
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < FD_WARPS; ++w) x += red[w * FD_ROWS * D + i];
      if (alone) {
        const int r = r0 + i / D, j = r / G, h = hk * G + r % G;
        static_cast<T*>(a.o)[b * a.so[0] + j * a.so[1] + h * a.so[2] +
                             i % D] = from_float<T>(x /
                                                    fmaxf(l_s[i / D], 1e-30f));
      } else {
        a.ws[part0 * D + i] = x;
      }
    }
    if (!alone) {
      float* ml = ml_of<D>(a);
      for (int rr = tid; rr < nr; rr += FD_THREADS) {
        ml[2 * (part0 + rr)] = m_s[rr];
        ml[2 * (part0 + rr) + 1] = l_s[rr];
      }
    }
  }
}

// Grid (ceil(Sq * G * D / 128), Hk, B): a thread an output element (row,
// column) of one (KV head, slot), merging the live spans' partials MB at
// a time: their loads are issued together, then folded into a running
// (max, sum, acc) by rescaling.  A slot with one live span is left to that
// span's block, which wrote o; one with none gets zeros.
template <typename T, int D>
__global__ void __launch_bounds__(FD_THREADS)
    flash_decode_merge_kernel(const DecodeArgs a) {
  constexpr int MB = 8;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hk, R = a.Sq * G;
  const LiveRange lr(a, b);
  const int i0 = lr.lo / FD_SPLIT;
  const int i1 = lr.hi > lr.lo ? (lr.hi + FD_SPLIT - 1) / FD_SPLIT : i0;
  // every block waits, so the merge grid ends after the split grid and
  // whatever the stream runs next sees o whole
  wait_for_primary();
  if (i1 - i0 == 1) return;  // that span's block wrote o
  const float* ml = ml_of<D>(a);
  T* o = static_cast<T*>(a.o);
  const int i = blockIdx.x * FD_THREADS + threadIdx.x;
  if (i < R * D) {
    const int r = i / D, d = i % D;
    const int j = r / G, h = hk * G + r % G;
    float mx = NEG_INF, l = 0.f, acc = 0.f;
    for (int sp0 = i0; sp0 < i1; sp0 += MB) {
      float mi[MB], li[MB], ai[MB];
#pragma unroll
      for (int u = 0; u < MB; ++u) {
        mi[u] = NEG_INF;
        li[u] = 0.f;
        ai[u] = 0.f;
        if (sp0 + u < i1) {
          const long long p = part_of(a, b, hk, sp0 + u, r);
          mi[u] = ml[2 * p];
          li[u] = ml[2 * p + 1];
          ai[u] = a.ws[p * D + d];
        }
      }
      float m_new = mx;
#pragma unroll
      for (int u = 0; u < MB; ++u) m_new = fmaxf(m_new, mi[u]);
      const float c = expf(mx - m_new);
      l *= c;
      acc *= c;
#pragma unroll
      for (int u = 0; u < MB; ++u) {
        const float cu = expf(mi[u] - m_new);
        l += li[u] * cu;
        acc += ai[u] * cu;
      }
      mx = m_new;
    }
    o[b * a.so[0] + j * a.so[1] + h * a.so[2] + d] =
        from_float<T>(acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, typename V, bool PAGED, int D>
static cudaError_t launch_d(const DecodeArgs& a, int B, cudaStream_t s) {
  constexpr int smem = SplitSmem<V, D>::BYTES;
  auto split = flash_decode_split_kernel<T, V, PAGED, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  if (a.nsplit > 0) {  // else no position: the merge writes zeros
    split<<<dim3(a.nsplit, a.Hk, B), FD_THREADS, smem, s>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  // queued behind the split kernel, started early (programmatic
  // dependent launch), waiting in wait_for_primary() for its partials
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3((a.Sq * (a.H / a.Hk) * D + FD_THREADS - 1) / FD_THREADS,
                     a.Hk, B);
  cfg.blockDim = dim3(FD_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, flash_decode_merge_kernel<T, D>, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, bool QUANT, bool PAGED>
static cudaError_t launch(const DecodeArgs& a, int B, int D,
                          cudaStream_t s) {
  using V = typename std::conditional<QUANT, int8_t, T>::type;
  switch (D) {
    case 32: return launch_d<T, V, PAGED, 32>(a, B, s);
    case 64: return launch_d<T, V, PAGED, 64>(a, B, s);
    default: return launch_d<T, V, PAGED, 128>(a, B, s);
  }
}

template <bool QUANT, bool PAGED>
static int run(const void* q, void* o, const void* k, const void* v,
               const void* k_scale, const void* v_scale, const void* lengths,
               const void* q_lens, const void* tables, int is_bf16, int B,
               int Sq, int H, int Hk, int S, int bs, int D,
               const long long* strides, float scale, int window, int ring,
               void* workspace, int split, void* stream) {
  if ((D != 32 && D != 64 && D != 128) || split != FD_SPLIT)
    return (int)cudaErrorInvalidValue;
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
  a.ws = static_cast<float*>(workspace);
  a.B = B;
  a.Sq = Sq;
  a.H = H;
  a.Hk = Hk;
  a.bs = PAGED ? bs : 0;
  a.S = PAGED ? S * bs : S;
  a.nsplit = (a.S + FD_SPLIT - 1) / FD_SPLIT;
  long long* dst[6] = {a.sq, a.so, a.sk, a.sv, a.sks, a.svs};
  for (int t = 0; t < 6; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  a.st = strides[18];
  a.scale = scale;
  a.window = window;
  a.ring = ring;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16, QUANT, PAGED>(a, B, D, s)
                       : launch<float, QUANT, PAGED>(a, B, D, s));
}

}  // namespace repro_torch

// The four entry points share one C signature.  q (B, Sq, H, D) and o like
// it, float32 or bf16 (is_bf16); k/v the cache values, q's type or int8;
// k_scale/v_scale the f32 scales of an int8 cache (else null); lengths
// (B,) int32; q_lens (B,) int32 or null (every row live); tables (B, nb)
// int32 for the paged layouts (else null).  S is the positions of a dense
// cache, or nb for a paged one; bs the block size (paged only).  strides:
// 19 element strides -- q, o, k, v, k_scale, v_scale, three each, then the
// table's row stride.  workspace: B * Hk * ceil(S' / split) * Sq * (H / Hk)
// * (D + 2) float32 (S' = S, or nb * bs paged) for the splits' partials;
// split must be the kernel's span of 64 keys.  Launches the split and the
// merge kernel on stream; returns the first launch error (0 if none).
#define REPRO_FD_ENTRY(NAME, QUANT, PAGED)                                      \
  extern "C" int NAME(const void* q, void* o, const void* k, const void* v,    \
                      const void* k_scale, const void* v_scale,                \
                      const void* lengths, const void* q_lens,                 \
                      const void* tables, int is_bf16, int B, int Sq, int H,   \
                      int Hk, int S, int bs, int D, const long long* strides,  \
                      float scale, int window, int ring, void* workspace,      \
                      int split, void* stream) {                               \
    return repro_torch::run<QUANT, PAGED>(                                     \
        q, o, k, v, k_scale, v_scale, lengths, q_lens, tables, is_bf16, B, Sq, \
        H, Hk, S, bs, D, strides, scale, window, ring, workspace, split,       \
        stream);                                                               \
  }

REPRO_FD_ENTRY(repro_flash_decode, false, false)
REPRO_FD_ENTRY(repro_flash_decode_quant, true, false)
REPRO_FD_ENTRY(repro_flash_decode_paged, false, true)
REPRO_FD_ENTRY(repro_flash_decode_paged_quant, true, true)
#undef REPRO_FD_ENTRY
