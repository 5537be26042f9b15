// Shared device and host code of the IVF band scan (csrc/ivf_scan.cu)
// and the fused two-tier probe (csrc/fused_serve.cu): one launch, one
// thread-block cluster per query, no scratch in device memory.
//
// What bounds it. At the serving shape (B = 32 queries, nprobe = 8
// bands of cap = 672 rows x d = 64 int8 codes, an fp32 scale and an
// int32 id a row) a call reads ~12.2 MB of distinct bands: 3.7 us at
// 3.35 TB/s, against 22 MFLOP. Neither limit is reached. On one H100
// about half the time goes to the launch and the bands' arrival, and
// most of the rest to the SMs' instruction issue: two instructions a
// code to score (a byte extract and an fp64 FMA), then the selection
// and the merge, with up to three blocks sharing an SM (variants timed
// in turns, PERF.md). The first CUDA version (a block per (query,
// band), a 1024-key bitonic sort a block, a second launch to merge)
// spent half of its 39 us in that sort and ~4 us in the merge launch.
//
// Design.
// 1. One cluster of cs = min(units, 8) blocks a query. A unit is a
//    chunk of rows of one probed band, or for the fused probe one slice
//    of the dynamic tier, that fits a 48 KiB stage; a band of 672 x 64
//    codes is one unit. Block r takes units r, r + cs, ..., so one code
//    path covers every nprobe, cap and tile size.
// 2. Staging (the TPU kernel's DMA double buffer): a unit's codes are
//    one contiguous run, copied into shared memory by one TMA bulk copy
//    (cp.async.bulk, completing on an mbarrier by bytes); its scales
//    and ids (16-byte aligned only when cap % 4 == 0) come by 4-byte
//    cp.async, whose completion arrives on the same mbarrier. A block's
//    first two units are issued before any scoring; later ones go
//    through the two-stage ring as stages free up. Each stage is sized
//    for the units that pass through it.
// 3. Scoring from shared memory: L lanes a row (L = d / 16 rounded up
//    to a power of two, at most 32), each lane one 16-byte chunk of the
//    row, so a warp reads contiguous 16-byte words with no bank
//    conflict; each lane keeps its 16 (or 8) query values in
//    registers, scores two rows at a time in four FMA chains each, and
//    the lanes' partial sums meet by shuffles.
// 4. Selection without a full sort. A block keeps a running list of its
//    best n = min(C, rows it has seen) keys, sorted. For each unit, the
//    list and the unit's keys are binned by score into 256 bins spread
//    linearly between the best score and the worst non-pad score; the
//    first bin at which the count reaches n is the threshold, and the
//    keys in it or better (n and a few, for scores spread as a band's
//    are) each find their place by counting the survivors ahead of
//    them. Five block barriers a unit, whatever the band's size;
//    kernels/ivf_scan/ref.py:threshold_survivors mirrors the threshold.
// 5. The merge in the same launch: every block writes its sorted lists
//    into the receive region of the cluster's last block (the one with
//    the fewest units) through distributed shared memory and arrives on
//    that block's mbarrier (release, cluster scope); the last block
//    waits on it (acquire), places each key by binary searches in the
//    other lists and writes the outputs. The one cluster barrier is
//    split (arrive at the start, wait before the writes), so no block
//    waits on it; no global partials, no second launch.
//
// Candidates are ordered by (score desc, id asc). A (score, id) pair
// packs into one 64-bit key whose unsigned ascending order is that
// order, so equal pairs (the (NEG, -1) pads) rank together and ties
// between bands break by the lower global id, as in the plain version.
//
// Exact fp64 selection. Scores are dot products accumulated in fp64 and
// rounded once to fp32; the plain PyTorch version does the same with
// its own summation order. An int8 code (or a bf16 value) times an
// fp32 query value needs at most 32 significant bits, so every product
// is exact in fp64, and so is every partial sum as long as a row's
// products span fewer than 2^53 units of the smallest product's last
// place (for an int8 row: no nonzero query component more than ~2^15
// times smaller than the largest). Then the fp64 sum does not depend on
// the order of the additions: the lanes' split of a row, the four FMA
// chains, the shuffle tree and the plain version's matmul all give the
// same fp32 score and the same selection. (Outside that condition the
// orders differ by one fp64 rounding, which moves the fp32 score only
// when the sum lies within 2^-53 of an fp32 rounding boundary.) Two
// exact rewrites keep the fp64 unit at one FMA a value:
//  - int8: the code c is read as u = c + 128 (one XOR a word) and the
//    byte itself is the bit pattern of the fp64 value u * 2^-1074; the
//    query is held as q * 2^992, so each FMA adds u * q * 2^-82
//    exactly, and the row's dot is sum * 2^82 - 128 * sum_j q_j, both
//    terms exact under the same condition;
//  - bf16: the value's 15 bits below the sign, shifted into the high
//    word of an fp64, are the fp64 value v * 2^-896 (normal and
//    subnormal alike); the query is held as q * 2^896.
// Both scalings are powers of two, so the products are the same real
// numbers as c * q and v * q.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>
#include <mutex>

// Internal to each source that includes it: the two entry points each
// get their own kernel and launch cache.
namespace ivf_band {
namespace {

namespace cg = cooperative_groups;
using u64 = unsigned long long;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BINS = 256;               // score bins of the threshold pass
constexpr int MAX_CLUSTER = 8;          // the portable cluster size
constexpr int STAGE_BYTES = 48 * 1024;  // a unit's rows: one stage
constexpr int RANK_DIRECT = 64;         // fewer keys: rank them all
constexpr int MAX_SMEM = 227 * 1024;    // dynamic shared memory a block
constexpr float NEG = -2.0f;            // below any cosine; pads
constexpr unsigned NEG_HI = 0xC0000000u;  // high word of a NEG key
constexpr double I8_Q = 0x1p992;        // query scale, int8 rows
constexpr double I8_UNSCALE = 0x1p82;
constexpr double BF16_Q = 0x1p896;      // query scale, bf16 rows

__device__ __forceinline__ u64 make_key(float v, int id) {
  if (v == 0.f) v = 0.f;                    // -0 and +0 compare equal
  unsigned u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending floats
  return (static_cast<u64>(~u) << 32) |
         static_cast<unsigned>(id + 1);     // id -1 (pad) -> 0
}

// The score of a key from its high word.
__device__ __forceinline__ float hi_value(unsigned hi) {
  unsigned u = ~hi;
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ float key_value(u64 key) {
  return hi_value(static_cast<unsigned>(key >> 32));
}

__device__ __forceinline__ int key_id(u64 key) {
  return static_cast<int>(static_cast<unsigned>(key & 0xffffffffu)) - 1;
}

// ---------------------------------------------------------------------
// Launch parameters
// ---------------------------------------------------------------------

// One kind of rows: the static tier's int8 bands or the dynamic tier's
// bf16 tiles. Item i of query b is band item_ids[b * items + i] (or
// tile i when item_ids is null), `rows` rows of `vbytes` bytes each.
struct Source {
  const unsigned char* vals;
  const float* scale;        // per-row scale (int8) or nullptr (bf16)
  const int* ids;            // per-row global id, -1 = pad or invalid
  const int* item_ids;       // (B, items) or nullptr
  int items, rows, vbytes;
  int chunk, chunks, units;  // rows a unit, units an item, units a query
  int c;                     // candidates out a query
  int lcap;                  // keys a block's list holds
  float* out_v;
  int* out_i;
};

struct Params {
  const float* q;            // (B, d) L2-normalized
  int d, n_src, units, cs, nst;
  int late_arrive;           // the receive region overlays the stages
  int rows_cap;              // rows of the largest unit
  // dynamic shared memory, bytes from its start: the ring's two stages
  // (each sized for the units that pass through it; a unit's scales and
  // ids at off_scale / off_ids from its stage), the lists, the unit's
  // keys, the survivors, the query, the stages' mbarriers, and the
  // leader's receive region (cs lists of lcap keys a source), which
  // overlays the stages when it would not fit beside them
  int off_stage[2], off_scale[2], off_ids[2];
  int off_list[2], off_ukeys, off_surv, off_qs, off_bar, off_recv[2];
  Source src[2];
};

// ---------------------------------------------------------------------
// Async copies
// ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(u64* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(u64* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait for the phase of parity `parity` to complete. A copy that never
// lands traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(u64* bar, unsigned parity) {
  for (unsigned spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1u << 22)) __trap();
  }
}

// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) into shared memory, completing on `bar` by bytes.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         unsigned bytes, u64* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

// This thread's arrival on `bar`, made when its cp.asyncs so far land.
__device__ __forceinline__ void cp_async_arrive(u64* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(smem_u32(bar)) : "memory");
}

// ---------------------------------------------------------------------
// Units
// ---------------------------------------------------------------------

struct Unit {
  int s, rows;               // source, rows in the unit
  const unsigned char* vals;
  const float* scale;
  const int* ids;
};

__device__ __forceinline__ Unit unit_of(const Params& p, int u, int b) {
  Unit un;
  un.s = u < p.src[0].units ? 0 : 1;
  const Source& S = p.src[un.s];
  const int v = u - (un.s ? p.src[0].units : 0);
  const int item = v / S.chunks, row0 = (v % S.chunks) * S.chunk;
  un.rows = min(S.chunk, S.rows - row0);
  const size_t g = S.item_ids ? (size_t)__ldg(S.item_ids +
                                              (size_t)b * S.items + item)
                              : (size_t)item;
  const size_t base = g * S.rows + row0;
  un.vals = S.vals + base * S.vbytes;
  un.scale = S.scale ? S.scale + base : nullptr;
  un.ids = S.ids + base;
  return un;
}

// Issue every copy of unit `un` into ring stage `st` (all threads take
// part).
__device__ __forceinline__ void issue(const Params& p, const Unit& un,
                                      unsigned char* smem, int st) {
  unsigned char* stage = smem + p.off_stage[st];
  u64* bar = reinterpret_cast<u64*>(smem + p.off_bar) + st;
  if (threadIdx.x == 0) {
    const unsigned bytes = un.rows * p.src[un.s].vbytes;
    mbar_expect_tx(bar, bytes);
    bulk_g2s(stage, un.vals, bytes, bar);
  }
  float* sc = reinterpret_cast<float*>(stage + p.off_scale[st]);
  int* id = reinterpret_cast<int*>(stage + p.off_ids[st]);
  for (int i = threadIdx.x; i < un.rows; i += THREADS) {
    if (un.scale) cp_async4(sc + i, un.scale + i);
    cp_async4(id + i, un.ids + i);
  }
  cp_async_arrive(bar);
}

// ---------------------------------------------------------------------
// Scoring
// ---------------------------------------------------------------------

// fp64 partial dot of one 16-byte chunk of an int8 row (16 codes) with
// the lane's scaled query values (see the note: u * 2^-1074 * q * 2^992),
// in four independent chains (acc[b] takes byte b of each word).
__device__ __forceinline__ void chunk_dot_i8(int4 w, const double* qr,
                                             double (&acc)[4]) {
  const unsigned words[4] = {static_cast<unsigned>(w.x),
                             static_cast<unsigned>(w.y),
                             static_cast<unsigned>(w.z),
                             static_cast<unsigned>(w.w)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned u = words[k] ^ 0x80808080u;       // code + 128
#pragma unroll
    for (int b = 0; b < 4; ++b)
      acc[b] = fma(__hiloint2double(0, static_cast<int>(
                       __byte_perm(u, 0, 0x4440 + b))),
                   qr[4 * k + b], acc[b]);
  }
}

// fp64 partial dot of one 16-byte chunk of a bf16 row (8 values) with
// the lane's scaled query values (v * 2^-896 * q * 2^896), in four
// independent chains.
__device__ __forceinline__ void chunk_dot_bf16(int4 w, const double* qr,
                                               double (&acc)[4]) {
  const unsigned words[4] = {static_cast<unsigned>(w.x),
                             static_cast<unsigned>(w.y),
                             static_cast<unsigned>(w.z),
                             static_cast<unsigned>(w.w)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned x = words[k];
    const unsigned lo = ((x << 16) & 0x80000000u) | ((x << 13) & 0x0fffe000u);
    const unsigned hi = (x & 0x80000000u) | ((x >> 3) & 0x0fffe000u);
    acc[(2 * k) & 3] = fma(__hiloint2double(static_cast<int>(lo), 0),
                           qr[2 * k], acc[(2 * k) & 3]);
    acc[(2 * k + 1) & 3] = fma(__hiloint2double(static_cast<int>(hi), 0),
                               qr[2 * k + 1], acc[(2 * k + 1) & 3]);
  }
}

// The lane's 16 (int8) or 8 (bf16) scaled query values of chunk `c`.
template <bool I8>
__device__ __forceinline__ void query_chunk(const double* qs, int c, int d,
                                            double* qr) {
  constexpr int V = I8 ? 16 : 8;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int k = c * V + j;
    qr[j] = k < d ? qs[k] * (I8 ? I8_Q : BF16_Q) : 0.0;
  }
}

// The lane's partial dot of stage row `r` (rows of `vbytes` bytes,
// chunks sub, sub + L, ...), its first chunk against `qr`.
template <bool I8>
__device__ __forceinline__ double row_dot(const unsigned char* stage, int r,
                                          int vbytes, int nch, int sub,
                                          int L, const double* qr,
                                          const double* qs, int d) {
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  const int4* row = reinterpret_cast<const int4*>(stage + r * vbytes);
  if (sub < nch) {
    if (I8) chunk_dot_i8(row[sub], qr, acc);
    else chunk_dot_bf16(row[sub], qr, acc);
  }
  for (int c = sub + L; c < nch; c += L) {     // d > 512 (256) only
    double qx[16];
    query_chunk<I8>(qs, c, d, qx);
    if (I8) chunk_dot_i8(row[c], qx, acc);
    else chunk_dot_bf16(row[c], qx, acc);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// Score the unit's rows in ring stage `st` into keys ukeys[0, rows);
// fold every key's high word into (kmin, kmax): the best key, the worst
// non-pad. L lanes a row; each lane scores two rows a step.
template <bool I8>
__device__ __forceinline__ void score_unit(const Params& p,
                                           const unsigned char* smem,
                                           int st, int rows,
                                           const double* qs,
                                           double qsum128, u64* ukeys,
                                           unsigned& kmin, unsigned& kmax) {
  const int vbytes = I8 ? p.d : 2 * p.d;
  const int nch = vbytes / 16;
  int L = 1;
  while (L < nch && L < 32) L <<= 1;
  const int lane = threadIdx.x & 31, sub = lane & (L - 1);
  const int per_step = WARPS * (32 / L);
  const int my_row = (threadIdx.x >> 5) * (32 / L) + lane / L;
  double qr[16];
  query_chunk<I8>(qs, sub, p.d, qr);
  const unsigned char* stage = smem + p.off_stage[st];
  const float* sc = reinterpret_cast<const float*>(stage + p.off_scale[st]);
  const int* ids = reinterpret_cast<const int*>(stage + p.off_ids[st]);
  for (int r0 = 0; r0 < rows; r0 += 2 * per_step) {   // uniform trip count
    double acc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + h * per_step + my_row;
      acc[h] = r < rows ? row_dot<I8>(stage, r, vbytes, nch, sub, L, qr,
                                      qs, p.d)
                        : 0.0;
    }
    for (int off = L >> 1; off > 0; off >>= 1) {
      acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], off);
      acc[1] += __shfl_xor_sync(0xffffffffu, acc[1], off);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + h * per_step + my_row;
      if (r < rows && sub == 0) {
        const int id = ids[r];
        float v = NEG;
        if (id >= 0) {
          v = I8 ? __double2float_rn(fma(acc[h], I8_UNSCALE, -qsum128)) *
                       sc[r]
                 : __double2float_rn(acc[h]);
        }
        const u64 key = make_key(v, id < 0 ? -1 : id);
        ukeys[r] = key;
        const unsigned hi = static_cast<unsigned>(key >> 32);
        kmin = min(kmin, hi);
        if (hi < NEG_HI) kmax = max(kmax, hi);
      }
    }
  }
}

// ---------------------------------------------------------------------
// Selection
// ---------------------------------------------------------------------

struct Shared {
  unsigned kmin, kmax;       // key range of the keys being selected
  int bstar, cnt;            // threshold bin, survivors so far
  int len[2];                // keys in each source's list
  int rlen[2][MAX_CLUSTER];  // lengths of the lists received (leader)
  u64 merge_bar;             // the other blocks' lists landed (leader)
  double qsum128;            // 128 * sum_j q_j
  int hist[BINS];
};

// Bin of a key's score: 0 for the best score, BINS - 1 for the worst
// non-pad score and below (pads). Monotone in the score, so every key
// in a bin below the threshold bin beats every key above it.
__device__ __forceinline__ int bin_of(u64 key, float vbest, float inv) {
  const float t = vbest - key_value(key);
  return t > 0.f ? static_cast<int>(fminf(t * inv, BINS - 1.f)) : 0;
}

// The best n of the m keys list[0, len) ++ ukeys[0, m - len) into
// list[0, n), sorted, and n into *len_out. Called by all threads after
// the barrier that made the keys and sh.kmin / sh.kmax final; ends with
// a barrier.
__device__ __forceinline__ void select_into(u64* list, int len,
                                            const u64* ukeys, int m, int n,
                                            u64* surv, int* len_out,
                                            Shared& sh) {
  const int tid = threadIdx.x, lane = tid & 31;
  const bool thresholded = n < m && m > RANK_DIRECT;
  const float vbest = hi_value(sh.kmin);
  const float vworst = sh.kmax ? hi_value(sh.kmax) : vbest;
  const float inv = vbest > vworst ? BINS / (vbest - vworst) : 0.f;
  auto key_at = [&](int j) { return j < len ? list[j] : ukeys[j - len]; };
  if (thresholded) {
    for (int j = tid; j < m; j += THREADS)
      atomicAdd(&sh.hist[bin_of(key_at(j), vbest, inv)], 1);
    __syncthreads();
    if (tid < 32) {            // first bin at which the count reaches n
      int c[BINS / 32], tot = 0;
#pragma unroll
      for (int k = 0; k < BINS / 32; ++k) {
        c[k] = sh.hist[lane * (BINS / 32) + k];
        sh.hist[lane * (BINS / 32) + k] = 0;
        tot += c[k];
      }
      int inc = tot;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += t;
      }
      const int first = __ffs(__ballot_sync(0xffffffffu, inc >= n)) - 1;
      if (lane == first) {
        int acc = inc - tot, k = 0;
        while (acc + c[k] < n) acc += c[k++];
        sh.bstar = lane * (BINS / 32) + k;
      }
    }
    __syncthreads();
  }
  const int bstar = thresholded ? sh.bstar : BINS;
  for (int j0 = 0; j0 < m; j0 += THREADS) {       // compact survivors
    const int j = j0 + tid;
    u64 key = 0;
    bool ok = false;
    if (j < m) {
      key = key_at(j);
      ok = bin_of(key, vbest, inv) <= bstar;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, ok);
    int base = 0;
    if (lane == 0 && mask) base = atomicAdd(&sh.cnt, __popc(mask));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (ok) surv[base + __popc(mask & ((1u << lane) - 1))] = key;
  }
  __syncthreads();
  const int S = sh.cnt;
  for (int i = tid; i < S; i += THREADS) {        // place by rank
    const u64 key = surv[i];
    int r = 0;
    for (int j = 0; j < S && r < n; ++j) {
      const u64 o = surv[j];
      r += (o < key) | ((o == key) & (j < i));
    }
    if (r < n) list[r] = key;
  }
  if (tid == 0) {            // ready for the next unit
    *len_out = n;
    sh.kmin = ~0u;
    sh.kmax = 0u;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------

__device__ __forceinline__ unsigned warp_min(unsigned x) {
  return __reduce_min_sync(0xffffffffu, x);
}
__device__ __forceinline__ unsigned warp_max(unsigned x) {
  return __reduce_max_sync(0xffffffffu, x);
}

// Split cluster barrier: every thread of every block arrives once and
// waits once before the merge, by which time the leader's merge barrier
// is initialized (its fence.mbarrier_init orders that). The arrive comes
// at the start (relaxed: nothing else needs ordering), or after the
// block's units when the receive region overlays the stages (release:
// the block's reads of its stages come before any block writes there).
__device__ __forceinline__ void cluster_arrive(bool release) {
  if (release)
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  else
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Arrive on the mbarrier at `bar` in the shared memory of cluster block
// `rank`, releasing this block's writes to it at cluster scope.
__device__ __forceinline__ void remote_arrive(u64* bar, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
      ::"r"(remote) : "memory");
}

// Wait, at cluster scope, for the merge barrier's first phase.
__device__ __forceinline__ void merge_wait(u64* bar) {
  for (unsigned spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1],"
        " 0;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)) : "memory");
    if (done) return;
    if (spins > (1u << 22)) __trap();
  }
}

// Three blocks an SM (at most 85 registers a thread): a cluster of 8
// per query for B = 32 queries then runs in one wave.
__global__ void __launch_bounds__(THREADS, 3)
band_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = p.cs, rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / cs, tid = threadIdx.x;
  const int leader = cs - 1;                 // the fewest units
  const int mine = (p.units - rank + cs - 1) / cs;
  u64* bar = reinterpret_cast<u64*>(smem + p.off_bar);
  u64* ukeys = reinterpret_cast<u64*>(smem + p.off_ukeys);
  u64* surv = reinterpret_cast<u64*>(smem + p.off_surv);
  double* qs = reinterpret_cast<double*>(smem + p.off_qs);
  auto list = [&](int s) {
    return reinterpret_cast<u64*>(smem + p.off_list[s]);
  };
  auto recv = [&](int s) {
    return reinterpret_cast<u64*>(smem + p.off_recv[s]);
  };

  const Unit first = unit_of(p, rank, b);   // its band id loads meanwhile
  if (tid == 0) {
    for (int k = 0; k < p.nst; ++k) mbar_init(bar + k, THREADS + 1);
    if (rank == leader && cs > 1) mbar_init(&sh.merge_bar, cs - 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sh.kmin = ~0u;
    sh.kmax = 0u;
    sh.cnt = 0;
    sh.len[0] = sh.len[1] = 0;
  }
  for (int j = tid; j < BINS; j += THREADS) sh.hist[j] = 0;
  __syncthreads();
  if (!p.late_arrive) cluster_arrive(false);
  issue(p, first, smem, 0);                 // every stage in flight
  if (mine > 1 && p.nst > 1) issue(p, unit_of(p, rank + cs, b), smem, 1);
  const float* q = p.q + (size_t)b * p.d;
  for (int j = tid; j < p.d; j += THREADS) qs[j] = static_cast<double>(q[j]);
  if (tid < 32) {            // 128 * sum_j q_j, exact as the dots are
    double t = 0.0;
    for (int j = tid; j < p.d; j += 32) t += static_cast<double>(q[j]);
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_xor_sync(0xffffffffu, t, off);
    if (tid == 0) sh.qsum128 = 128.0 * t;
  }
  __syncthreads();

  for (int k = 0; k < mine; ++k) {
    const int u = rank + k * cs, st = k % p.nst;
    const int s = u < p.src[0].units ? 0 : 1;
    const Source& S = p.src[s];
    const int v = u - (s ? p.src[0].units : 0);
    const int rows = min(S.chunk, S.rows - (v % S.chunks) * S.chunk);
    const int len = sh.len[s];
    u64* lst = list(s);
    unsigned kmin = ~0u, kmax = 0u;
    for (int j = tid; j < len; j += THREADS) {
      const unsigned hi = static_cast<unsigned>(lst[j] >> 32);
      kmin = min(kmin, hi);
      if (hi < NEG_HI) kmax = max(kmax, hi);
    }
    mbar_wait(bar + st, (k / p.nst) & 1);
    if (S.scale)
      score_unit<true>(p, smem, st, rows, qs, sh.qsum128, ukeys, kmin,
                       kmax);
    else
      score_unit<false>(p, smem, st, rows, qs, 0.0, ukeys, kmin, kmax);
    kmin = warp_min(kmin);
    kmax = warp_max(kmax);
    if ((tid & 31) == 0) {
      atomicMin(&sh.kmin, kmin);
      atomicMax(&sh.kmax, kmax);
    }
    if (tid == 0) sh.cnt = 0;
    __syncthreads();         // keys final; the stage is free again
    if (k + p.nst < mine) issue(p, unit_of(p, u + p.nst * cs, b), smem, st);
    const int m = len + rows, n = min(S.lcap, m);
    select_into(lst, len, ukeys, m, n, surv, &sh.len[s], sh);
  }

  // merge: every block writes its sorted lists into the leader's receive
  // region and arrives on the leader's merge barrier; ...
  if (p.late_arrive) cluster_arrive(true);  // the leader's stages are free
  cluster_wait();
  for (int s = 0; s < p.n_src; ++s) {
    const int len = sh.len[s], lcap = p.src[s].lcap;
    u64* dst = cluster.map_shared_rank(recv(s), leader) + rank * lcap;
    for (int j = tid; j < len; j += THREADS) dst[j] = list(s)[j];
    if (tid == 0) *cluster.map_shared_rank(&sh.rlen[s][rank], leader) = len;
  }
  __syncthreads();
  if (rank != leader) {
    if (tid == 0) remote_arrive(&sh.merge_bar, leader);
    return;
  }
  if (cs > 1) merge_wait(&sh.merge_bar);
  // ... the leader places each key by its rank among all of them
  for (int s = 0; s < p.n_src; ++s) {
    const int lcap = p.src[s].lcap, c = p.src[s].c;
    float* out_v = p.src[s].out_v + (size_t)b * c;
    int* out_i = p.src[s].out_i + (size_t)b * c;
    int top = 1;               // a power of two above every list length
    while (top <= lcap) top <<= 1;
    const u64* g = recv(s);
    for (int j = tid; j < cs * lcap; j += THREADS) {
      const int r = j / lcap, i = j - r * lcap;
      if (i >= sh.rlen[s][r] || i >= c) continue;
      const u64 key = g[j];
      int lo[MAX_CLUSTER];     // keys of each list ahead of this one,
#pragma unroll                 // the lists' searches interleaved
      for (int l = 0; l < MAX_CLUSTER; ++l) lo[l] = 0;
      for (int w = top >> 1; w > 0; w >>= 1) {
#pragma unroll
        for (int l = 0; l < MAX_CLUSTER; ++l) {
          const int t = lo[l] + w;
          if (l < cs && l != r && t <= sh.rlen[s][l]) {
            const u64 o = g[l * lcap + t - 1];
            if (l < r ? o <= key : o < key) lo[l] = t;
          }
        }
      }
      int at = i;
#pragma unroll
      for (int l = 0; l < MAX_CLUSTER; ++l) at += lo[l];
      if (at < c) {          // pads and invalid slots are (NEG, -1)
        out_v[at] = key_value(key);
        out_i[at] = key_id(key);
      }
    }
  }
}

// ---------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------

inline int align16(int n) { return (n + 15) & ~15; }

// Source of `items` items a query, `rows` rows each, cut into at least
// `min_chunks` units an item, each of which fits one stage.
inline Source make_source(const void* vals, const float* scale,
                          const int* ids, const int* item_ids, int items,
                          int rows, int vbytes, int c, int min_chunks,
                          float* out_v, int* out_i) {
  Source S{};
  S.vals = static_cast<const unsigned char*>(vals);
  S.scale = scale;
  S.ids = ids;
  S.item_ids = item_ids;
  S.items = items;
  S.rows = rows;
  S.vbytes = vbytes;
  const int row_bytes = vbytes + 4 + (scale ? 4 : 0);
  const int fit = std::max(1, STAGE_BYTES / row_bytes);
  S.chunks = std::min(rows, std::max(min_chunks, (rows + fit - 1) / fit));
  S.chunk = (rows + S.chunks - 1) / S.chunks;
  S.chunks = (rows + S.chunk - 1) / S.chunk;
  S.units = items * S.chunks;
  S.c = c;
  S.out_v = out_v;
  S.out_i = out_i;
  return S;
}

// Ring stages and the shared-memory layout for the sources in p.src on
// clusters of `cs` blocks; returns the dynamic shared memory, or 0 if it
// exceeds a block's.
inline size_t plan_for(Params& p, int cs) {
  p.cs = cs;
  p.nst = std::min((p.units + p.cs - 1) / p.cs, 2);
  int vals_cap[2] = {0, 0}, rows_in[2] = {0, 0};
  int seen[2][MAX_CLUSTER] = {};   // rows of each source a block sees
  p.rows_cap = 0;
  for (int u = 0; u < p.units; ++u) {
    const int s = u < p.src[0].units ? 0 : 1;
    const Source& S = p.src[s];
    const int v = u - (s ? p.src[0].units : 0);
    const int rows = std::min(S.chunk, S.rows - (v % S.chunks) * S.chunk);
    const int st = (u / p.cs) % p.nst;
    vals_cap[st] = std::max(vals_cap[st], rows * S.vbytes);
    rows_in[st] = std::max(rows_in[st], rows);
    p.rows_cap = std::max(p.rows_cap, rows);
    seen[s][u % p.cs] += rows;
  }
  int lcap_max = 0;
  for (int s = 0; s < p.n_src; ++s) {
    Source& S = p.src[s];
    S.lcap = std::min(S.c, *std::max_element(seen[s], seen[s] + p.cs));
    lcap_max = std::max(lcap_max, S.lcap);
  }
  size_t recv = 0, at = 0;
  for (int s = 0; s < p.n_src; ++s) recv += align16(8 * p.cs * p.src[s].lcap);
  for (int st = 0; st < p.nst; ++st) {
    p.off_stage[st] = static_cast<int>(at);
    p.off_scale[st] = align16(vals_cap[st]);
    p.off_ids[st] = p.off_scale[st] + align16(4 * rows_in[st]);
    at += p.off_ids[st] + align16(4 * rows_in[st]);
  }
  const size_t rest = align16(8 * p.rows_cap) +
                      align16(8 * (lcap_max + p.rows_cap)) +
                      align16(8 * p.d) + 16;
  size_t lists = 0;
  for (int s = 0; s < p.n_src; ++s) lists += align16(8 * p.src[s].lcap);
  const size_t limit = static_cast<size_t>(MAX_SMEM) - sizeof(Shared);
  p.late_arrive = at + recv + lists + rest > limit;
  size_t r = p.late_arrive ? 0 : at;        // the receive region
  at = p.late_arrive ? std::max(at, recv) : at + recv;
  for (int s = 0; s < p.n_src; ++s) {
    p.off_recv[s] = static_cast<int>(r);
    r += align16(8 * p.cs * p.src[s].lcap);
    p.off_list[s] = static_cast<int>(at);
    at += align16(8 * p.src[s].lcap);
  }
  p.off_ukeys = static_cast<int>(at);
  at += align16(8 * p.rows_cap);
  p.off_surv = static_cast<int>(at);
  at += align16(8 * (lcap_max + p.rows_cap));
  p.off_qs = static_cast<int>(at);
  at += align16(8 * p.d);
  p.off_bar = static_cast<int>(at);
  at += 16;
  return at <= limit ? at : 0;
}

// The largest cluster, up to min(units, 8), whose layout fits a block
// (a smaller cluster gives each block longer lists to keep, but the
// leader fewer to receive); 0 if none does.
inline size_t plan(Params& p) {
  p.units = 0;
  for (int s = 0; s < p.n_src; ++s) p.units += p.src[s].units;
  for (int cs = std::min(p.units, MAX_CLUSTER); cs > 0; --cs) {
    const size_t smem = plan_for(p, cs);
    if (smem) return smem;
  }
  return 0;
}

// Launch one cluster of p.cs blocks per query. Fails (without launching)
// when the plan does not fit a block or no cluster of its size fits.
inline cudaError_t launch(Params& p, int B, cudaStream_t stream) {
  const size_t smem = plan(p);
  if (smem == 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * p.cs);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // clusters of this size and shared memory that fit the card at once,
  // asked once per (device, cluster size, shared memory)
  static std::mutex mu;
  static int seen[64][3];
  static int n_seen = 0;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(mu);
    bool known = false;
    for (int i = 0; i < n_seen && !known; ++i)
      known = seen[i][0] == dev && seen[i][1] == p.cs &&
              seen[i][2] == static_cast<int>(smem);
    if (!known) {
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, band_kernel, &cfg);
      if (err != cudaSuccess) return err;
      if (clusters < 1) return cudaErrorInvalidConfiguration;
      if (n_seen < 64) {
        seen[n_seen][0] = dev;
        seen[n_seen][1] = p.cs;
        seen[n_seen][2] = static_cast<int>(smem);
        ++n_seen;
      }
    }
  }
  err = cudaLaunchKernelEx(&cfg, band_kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
}  // namespace ivf_band
