// Fused cosine top-k for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/simsearch/kernel.py:simsearch
// (pallas_call at :93): normalize the queries and every corpus row in
// fp32, score, and keep a running top-k ordered by (value desc, index
// asc). The (B, N) score matrix never reaches device memory.
//
// What bounds it: bytes. At the serving shape (N = 4,194,304 rows,
// d = 64, fp32, B <= 32) the corpus is read once, 1 GiB, about 320 us
// at 3.35 TB/s. Scoring every row against 32 queries by fp32 FMAs
// (2*B*N*d, about 256 us at 67 TFLOP/s) would sit close to that, so the
// scan screens on the tensor cores and keeps exact fp32 for the few
// rows that can enter a top-k.
//
// Design. One persistent block per SM (8 warps) walks a stride of
// 128-row tiles. Each tile, in column chunks of 64, is staged whole by
// cp.async (16 bytes a thread, neighbour threads on neighbour
// addresses) into a ring of 2-4 shared-memory stages, so the next tiles
// are in flight while one is scored. A warp owns 16 rows of a tile and
// scores them against all queries of the launch with TF32 mma.sync
// (m16n8k8, fp32 accumulators; the queries' B fragments sit in shared
// memory in fragment order), and sums the rows' squares for their
// norms. A (row, query) pair is a candidate when its screened cosine
// lies within EPS of the query's running k-th best exact score; only
// candidates are rescored, exactly as the plain version's kernel order
// scores every row: fp32 FMAs over j in order for the dot and the
// squared norm, times rsqrtf(max(ss, 1e-18)), from the fp32 row (still
// staged when d <= 64, else re-read from device memory). The running
// top-k of each query lives in shared memory, owned by one warp that
// inserts candidates in the (value desc, index asc) order; its k-th
// value is the block's threshold. Blocks also share thresholds: each
// publishes its k-th best per query by an atomic max to a global word,
// and screens against the larger of its own and the global one (both
// lower bounds of the final k-th best score), so once the first blocks
// have met a query's best rows the others push almost no candidate.
// Every block writes its top-k per query, and a second launch merges
// the per-block lists in one pass a query and resets the global words.
// The kernel masks the ragged last tile itself (rows past N are
// zero-filled and never pushed), so the caller never pads.
//
// The screening margin EPS = 2^-8. With q_n the fp32 normalized query
// (|q_n| <= 1 + 2^-20) and c a corpus row, d <= 1024:
//  - TF32 keeps 10 explicit mantissa bits, so each operand the mma
//    reads is within 2^-10 of its fp32 value, relatively (truncated or
//    rounded), and each product within (2^-9 + 2^-20) |q_j c_j|;
//  - the fp32 accumulation over d terms adds at most d * 2^-23
//    sum_j |q_j c_j| <= 2^-13 |c|;
//  so the screened dot is within 0.00209 |c| of q_n . c (Cauchy-
//  Schwarz: sum_j |q_j c_j| <= |q_n| |c|). The screened squared norm
//  is an fp32 sum in another order, within d * 2^-24 of |c|^2
//  relatively; with rsqrtf's 2 ulp its inverse is within 3.1e-5, so the
//  screened cosine is within 0.00213 of the true one. The exact fp32
//  score is within 0.00016 of it by the same terms. Screened and exact
//  scores therefore differ by less than 0.0023 < EPS, and a pair whose
//  screened score lies below (k-th best exact score - EPS) cannot enter
//  the top-k. Rows with ss < 1e-18 use the same clamp on both sides,
//  which keeps the bound; inputs flushed as subnormals by the tensor
//  cores move a score by less than d * 2^-126 * 1e9. Ties and order
//  come from the exact scores alone, so the result equals a full exact
//  scan's.
#include <cuda_runtime.h>
#include <cfloat>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = WARPS * 16;     // corpus rows per tile
constexpr int CW = 64;               // columns per chunk of a tile
constexpr int KMAX = 32;
constexpr int MAX_STAGES = 4;
constexpr float EPS = 0.00390625f;   // 2^-8, see the note above
constexpr size_t SMEM_CAP = 227 * 1024;

__device__ __forceinline__ bool better(float v1, int i1, float v2,
                                       int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// Order-preserving int key of a float (no NaN), for atomicMax.
__device__ __forceinline__ int f2key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float key2f(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}
constexpr int KEY_NEG_INF = (int)0xff800000 ^ 0x7fffffff;   // f2key(-inf)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n committed groups of this thread are pending.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  }
}

// d += a * b on the tensor cores, TF32 inputs (the operand registers
// hold fp32 bits), fp32 accumulators. Fragments (lane = 4 gid + tig):
// a0 (gid, tig), a1 (gid + 8, tig), a2 (gid, tig + 4), a3 (gid + 8,
// tig + 4); b0 (k tig, n gid), b1 (k tig + 4, n gid); d0, d1 (gid,
// 2 tig + {0, 1}), d2, d3 (gid + 8, same).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const float4& a,
                                         float2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a.x)), "r"(__float_as_uint(a.y)),
        "r"(__float_as_uint(a.z)), "r"(__float_as_uint(a.w)),
        "r"(__float_as_uint(b.x)), "r"(__float_as_uint(b.y)));
}

// Insert (v, i) into the sorted list (lv, li)[0..k) of shared memory,
// one lane a slot, when it beats the k-th entry; the lane that ends up
// holding slot k-1 publishes it as the block's threshold and offers it
// to the global one. Warp-collective.
__device__ __forceinline__ void warp_insert(float* lv, int* li, int k,
                                            float v, int i, float* tv,
                                            int* ti, int* gthr) {
  const int lane = threadIdx.x & 31;
  const float ov = lane < k ? lv[lane] : -INFINITY;
  const int oi = lane < k ? li[lane] : INT_MAX;
  const int pos = __popc(__ballot_sync(0xffffffffu,
                                       lane < k && better(ov, oi, v, i)));
  const float pv = __shfl_up_sync(0xffffffffu, ov, 1);
  const int pi = __shfl_up_sync(0xffffffffu, oi, 1);
  if (pos < k && lane >= pos && lane < k) {
    const float nv = lane == pos ? v : pv;
    const int ni = lane == pos ? i : pi;
    lv[lane] = nv;
    li[lane] = ni;
    if (lane == k - 1) {
      *tv = nv;
      *ti = ni;
      atomicMax(gthr, f2key(nv));
    }
  }
  __syncwarp();
}

struct Smem {
  float* stage;     // [stages][ROWS][CW], 16-byte chunks swizzled by row
  float2* qfrag;    // [n_chunks][8 k-steps][NT][32 lanes] B fragments
  float* list_v;    // [QB][KMAX] running top-k, value desc, index asc
  int* list_i;
  float* thr_v;     // [QB] the k-th entry, the block's threshold
  int* thr_i;
  float* thr_g;     // [QB] the global threshold as last read
  float* q_inv;     // [QB] 1 / |q| as the queries were normalized
  unsigned* cand;   // [ROWS * QB] (row in tile << 5) | query
  int* n_cand;
};

template <int QB>
__host__ __device__ size_t smem_bytes(int n_chunks, int stages) {
  constexpr int NT = QB / 8;
  return sizeof(float) * (size_t)stages * ROWS * CW +
         sizeof(float2) * (size_t)n_chunks * 8 * NT * 32 +
         (sizeof(float) + sizeof(int)) * (size_t)QB * (KMAX + 1) +
         2 * sizeof(float) * QB + sizeof(unsigned) * (size_t)ROWS * QB + 16;
}

template <int QB>
__device__ Smem carve(unsigned char* raw, int n_chunks, int stages) {
  constexpr int NT = QB / 8;
  Smem s;
  s.stage = reinterpret_cast<float*>(raw);
  s.qfrag = reinterpret_cast<float2*>(s.stage + (size_t)stages * ROWS * CW);
  s.list_v = reinterpret_cast<float*>(s.qfrag + (size_t)n_chunks * 8 * NT *
                                                    32);
  s.list_i = reinterpret_cast<int*>(s.list_v + QB * KMAX);
  s.thr_v = reinterpret_cast<float*>(s.list_i + QB * KMAX);
  s.thr_i = reinterpret_cast<int*>(s.thr_v + QB);
  s.thr_g = reinterpret_cast<float*>(s.thr_i + QB);
  s.q_inv = s.thr_g + QB;
  s.cand = reinterpret_cast<unsigned*>(s.q_inv + QB);
  s.n_cand = reinterpret_cast<int*>(s.cand + ROWS * QB);
  return s;
}

// Stage tile unit t (row tile t / n_chunks of this block's stride,
// column chunk t % n_chunks) into ring slot `slot`.
__device__ __forceinline__ void load_unit(const float* __restrict__ corpus,
                                          int N, int d, int n_chunks,
                                          int t, float* dst) {
  const int tile = blockIdx.x + (t / n_chunks) * gridDim.x;
  const int ch = t % n_chunks;
  for (int x = threadIdx.x; x < ROWS * (CW / 4); x += THREADS) {
    const int r = x / (CW / 4), c = x % (CW / 4);
    const int row = tile * ROWS + r, col = ch * CW + 4 * c;
    const bool ok = row < N && col < d;
    cp_async16(dst + r * CW + 4 * (c ^ ((r & 1) << 2)),
               ok ? corpus + (size_t)row * d + col : corpus, ok);
  }
}

// Index in the fragment-ordered queries of the normalized pair
// (query b, columns j, j + 1), j even.
template <int NT>
__device__ __forceinline__ int qfrag_at(int b, int j) {
  const int jj = j % CW;
  const int ks = 2 * (jj / 16) + (jj % 4) / 2;
  return (((j / CW) * 8 + ks) * NT + b / 8) * 32 + 4 * (b % 8) +
         (jj % 16) / 4;
}

template <int QB>
__global__ void __launch_bounds__(THREADS, 1)
scan_kernel(const float* __restrict__ q, const float* __restrict__ corpus,
            int B, int N, int d, int k, int stages,
            float* __restrict__ part_v, int* __restrict__ part_i,
            int* __restrict__ gthr) {
  constexpr int NT = QB / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_chunks = (d + CW - 1) / CW;
  Smem sm = carve<QB>(smem_raw, n_chunks, stages);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  // normalize the queries once per block: rsqrt(max(sum x^2, 1e-18)),
  // as the TPU kernel does (and in the order the plain version's
  // kernel did); rows b >= B are zero and never selected
  for (int b = warp; b < QB; b += WARPS) {
    float ss = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float x = b < B ? q[(size_t)b * d + j] : 0.f;
      ss = fmaf(x, x, ss);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lane == 0) sm.q_inv[b] = rsqrtf(fmaxf(ss, 1e-18f));
  }
  for (int j = tid; j < QB * KMAX; j += THREADS) {
    sm.list_v[j] = -INFINITY;
    sm.list_i[j] = INT_MAX;
  }
  for (int b = tid; b < QB; b += THREADS) {
    sm.thr_v[b] = -INFINITY;
    sm.thr_i[b] = INT_MAX;
    sm.thr_g[b] = -INFINITY;
  }
  if (tid == 0) *sm.n_cand = 0;
  __syncthreads();
  // B fragments of the normalized queries, in fragment order: k-step
  // (kk, h) of chunk ch pairs mma column tig with query column
  // ch*64 + 16kk + 4tig + 2h and column tig + 4 with the next one (the
  // A fragments below read the same columns of the rows)
  for (int x = tid; x < n_chunks * 8 * NT * 32; x += THREADS) {
    const int ln = x & 31, nt = (x >> 5) % NT, ks = (x >> 5) / NT % 8;
    const int ch = (x >> 5) / NT / 8;
    const int n = nt * 8 + (ln >> 2);
    const int col = ch * CW + 16 * (ks >> 1) + 4 * (ln & 3) + 2 * (ks & 1);
    float2 v = make_float2(0.f, 0.f);
    if (n < B) {
      const float inv = sm.q_inv[n];
      if (col < d) v.x = q[(size_t)n * d + col] * inv;
      if (col + 1 < d) v.y = q[(size_t)n * d + col + 1] * inv;
    }
    sm.qfrag[x] = v;
  }

  const int n_tiles = (N + ROWS - 1) / ROWS;
  const int my_tiles = blockIdx.x < n_tiles
      ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int units = my_tiles * n_chunks;
  for (int s = 0; s < stages - 1; ++s) {
    if (s < units)
      load_unit(corpus, N, d, n_chunks, s,
                sm.stage + (size_t)s * ROWS * CW);
    cp_async_commit();
  }

  float acc[NT][4];
  float ss0 = 0.f, ss1 = 0.f;           // rows gid and gid + 8
  int gk = KEY_NEG_INF;                 // thread b < B: query b's global
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int t = 0; t < units; ++t) {
    cp_async_wait(stages - 2);
    __syncthreads();            // unit t landed; slot t - 1 is free
    if (t + stages - 1 < units)
      load_unit(corpus, N, d, n_chunks, t + stages - 1,
                sm.stage + (size_t)((t + stages - 1) % stages) * ROWS * CW);
    cp_async_commit();
    // the global thresholds: keep the value read one unit ago, and read
    // them again for the next unit, so the load's latency hides behind
    // this unit's work (a stale value is a smaller lower bound: safe)
    if (tid < B) {
      sm.thr_g[tid] = fmaxf(sm.thr_g[tid], key2f(gk));
      gk = __ldcg(gthr + tid);
    }

    const int ch = t % n_chunks;
    const float* st = sm.stage + (size_t)(t % stages) * ROWS * CW;
    const int r0 = warp * 16 + gid, r1 = r0 + 8;
    const float* row0 = st + r0 * CW;
    const float* row1 = st + r1 * CW;
    const float2* qf = sm.qfrag + (size_t)ch * 8 * NT * 32 + lane;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = (4 * kk + tig) ^ ((r0 & 1) << 2);   // r1 & 1 == r0 & 1
      const float4 x = *reinterpret_cast<const float4*>(row0 + 4 * c);
      const float4 y = *reinterpret_cast<const float4*>(row1 + 4 * c);
      ss0 = fmaf(x.x, x.x, ss0); ss0 = fmaf(x.y, x.y, ss0);
      ss0 = fmaf(x.z, x.z, ss0); ss0 = fmaf(x.w, x.w, ss0);
      ss1 = fmaf(y.x, y.x, ss1); ss1 = fmaf(y.y, y.y, ss1);
      ss1 = fmaf(y.z, y.z, ss1); ss1 = fmaf(y.w, y.w, ss1);
      const float4 a0 = make_float4(x.x, y.x, x.y, y.y);   // h = 0
      const float4 a1 = make_float4(x.z, y.z, x.w, y.w);   // h = 1
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_tf32(acc[nt], a0, qf[((2 * kk) * NT + nt) * 32]);
        mma_tf32(acc[nt], a1, qf[((2 * kk + 1) * NT + nt) * 32]);
      }
    }
    if (ch != n_chunks - 1) continue;

    // screen the tile's (row, query) pairs against the thresholds
    const int tile = blockIdx.x + (t / n_chunks) * gridDim.x;
    ss0 += __shfl_xor_sync(0xffffffffu, ss0, 1);
    ss0 += __shfl_xor_sync(0xffffffffu, ss0, 2);
    ss1 += __shfl_xor_sync(0xffffffffu, ss1, 1);
    ss1 += __shfl_xor_sync(0xffffffffu, ss1, 2);
    const float inv0 = rsqrtf(fmaxf(ss0, 1e-18f));
    const float inv1 = rsqrtf(fmaxf(ss1, 1e-18f));
    const bool ok0 = tile * ROWS + r0 < N, ok1 = tile * ROWS + r1 < N;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float lo[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int b = nt * 8 + 2 * tig + e;
        lo[e] = fmaxf(sm.thr_v[b], sm.thr_g[b]) - EPS;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = nt * 8 + 2 * tig + (e & 1);
        const bool ok = (e < 2 ? ok0 : ok1) && b < B;
        const float s = acc[nt][e] * (e < 2 ? inv0 : inv1);
        if (ok && s >= lo[e & 1]) {
          const int slot = atomicAdd(sm.n_cand, 1);
          sm.cand[slot] = ((unsigned)(e < 2 ? r0 : r1) << 5) | b;
        }
        acc[nt][e] = 0.f;
      }
    }
    ss0 = ss1 = 0.f;
    __syncthreads();
    const int n_cand = *sm.n_cand;
    if (n_cand == 0) continue;

    // rescore the candidates exactly; the warp that owns a query
    // (b % WARPS) inserts them into its list
    for (int x0 = 0; x0 < n_cand; x0 += 32) {
      const int x = x0 + lane;
      const unsigned cv = x < n_cand ? sm.cand[x] : 0u;
      const int b = cv & 31;
      bool mine = x < n_cand && b % WARPS == warp;
      float s = -INFINITY;
      int row = INT_MAX;
      if (mine) {
        const int r = (int)(cv >> 5);
        row = tile * ROWS + r;
        // the row from its stage when it is one chunk, else from device
        // memory; the normalized query from its B fragments
        const float* c = corpus + (size_t)row * d;
        const float* cs = st + r * CW;
        const int sw = (r & 1) << 2;
        float a = 0.f, ss = 0.f;
        for (int j = 0; j < d; j += 4) {
          const float4 cj = n_chunks == 1
              ? *reinterpret_cast<const float4*>(cs + 4 * ((j / 4) ^ sw))
              : __ldg(reinterpret_cast<const float4*>(c + j));
          const float2 q01 = sm.qfrag[qfrag_at<NT>(b, j)];
          const float2 q23 = sm.qfrag[qfrag_at<NT>(b, j + 2)];
          ss = fmaf(cj.x, cj.x, ss); ss = fmaf(cj.y, cj.y, ss);
          ss = fmaf(cj.z, cj.z, ss); ss = fmaf(cj.w, cj.w, ss);
          a = fmaf(q01.x, cj.x, a); a = fmaf(q01.y, cj.y, a);
          a = fmaf(q23.x, cj.z, a); a = fmaf(q23.y, cj.w, a);
        }
        s = a * rsqrtf(fmaxf(ss, 1e-18f));
        mine = better(s, row, sm.thr_v[b], sm.thr_i[b]);
      }
      for (unsigned m = __ballot_sync(0xffffffffu, mine); m; m &= m - 1) {
        const int src = __ffs(m) - 1;
        const int bb = __shfl_sync(0xffffffffu, b, src);
        const float vv = __shfl_sync(0xffffffffu, s, src);
        const int ii = __shfl_sync(0xffffffffu, row, src);
        warp_insert(sm.list_v + bb * KMAX, sm.list_i + bb * KMAX, k, vv,
                    ii, sm.thr_v + bb, sm.thr_i + bb, gthr + bb);
      }
    }
    __syncthreads();            // lists and thresholds final, cand read
    if (tid == 0) *sm.n_cand = 0;
  }
  cp_async_wait(0);

  // this block's partial list: part[(b * gridDim.x + block) * k + r]
  __syncthreads();
  for (int j = tid; j < B * k; j += THREADS) {
    const int b = j / k, r = j % k;
    const size_t o = ((size_t)b * gridDim.x + blockIdx.x) * k + r;
    part_v[o] = sm.list_v[b * KMAX + r];
    part_i[o] = sm.list_i[b * KMAX + r];
  }
}

// One warp per query row merges the n_blocks partial lists in one pass:
// lane r holds the r-th best so far, and an entry that beats the k-th
// is inserted in the (value desc, index asc) order. It also resets the
// query's global threshold for the next launch.
__global__ void merge_kernel(const float* __restrict__ part_v,
                             const int* __restrict__ part_i, int n_blocks,
                             int k, float* __restrict__ out_v,
                             int* __restrict__ out_i, int* gthr) {
  const int b = blockIdx.x, lane = threadIdx.x;
  if (lane == 0) gthr[b] = KEY_NEG_INF;
  const size_t base = (size_t)b * n_blocks * k;
  const int n = n_blocks * k;
  float lv = -INFINITY;
  int li = INT_MAX;
  for (int x0 = 0; x0 < n; x0 += 32) {
    const float v = x0 + lane < n ? part_v[base + x0 + lane] : -INFINITY;
    const int i = x0 + lane < n ? part_i[base + x0 + lane] : INT_MAX;
    const float kv = __shfl_sync(0xffffffffu, lv, k - 1);
    const int ki = __shfl_sync(0xffffffffu, li, k - 1);
    for (unsigned m = __ballot_sync(0xffffffffu, better(v, i, kv, ki)); m;
         m &= m - 1) {
      const int src = __ffs(m) - 1;
      const float cv = __shfl_sync(0xffffffffu, v, src);
      const int ci = __shfl_sync(0xffffffffu, i, src);
      const int pos = __popc(__ballot_sync(
          0xffffffffu, lane < k && better(lv, li, cv, ci)));
      const float pv = __shfl_up_sync(0xffffffffu, lv, 1);
      const int pi = __shfl_up_sync(0xffffffffu, li, 1);
      if (lane >= pos && lane < k) {
        lv = lane == pos ? cv : pv;
        li = lane == pos ? ci : pi;
      }
    }
  }
  if (lane < k) {
    out_v[(size_t)b * k + lane] = lv;
    out_i[(size_t)b * k + lane] = li;
  }
}

template <int QB>
cudaError_t launch_scan(const float* q, const float* corpus, int B, int N,
                        int d, int k, int n_blocks, float* part_v,
                        int* part_i, int* gthr, cudaStream_t stream) {
  const int n_chunks = (d + CW - 1) / CW;
  int stages = MAX_STAGES;
  while (stages > 2 && smem_bytes<QB>(n_chunks, stages) > SMEM_CAP)
    --stages;
  const size_t smem = smem_bytes<QB>(n_chunks, stages);
  if (smem > SMEM_CAP) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<QB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  scan_kernel<QB><<<n_blocks, THREADS, smem, stream>>>(
      q, corpus, B, N, d, k, stages, part_v, part_i, gthr);
  return cudaGetLastError();
}

}  // namespace

// queries (B, d) and corpus (N, d) fp32 row-major, 16-byte aligned,
// d % 4 == 0, d <= 1024, B <= 32, 1 <= k <= min(32, N). n_blocks scan
// blocks (one per SM is enough: a block keeps 2-4 tiles in flight);
// part_v/part_i hold B * n_blocks * k scratch; gthr holds B int32 words
// equal to KEY_NEG_INF (the key of -inf, 0x807fffff) on entry, and left
// so on return; out_v/out_i receive (B, k).
extern "C" int simsearch_topk(const void* q, const void* corpus, int B,
                              int N, int d, int k, int n_blocks,
                              void* part_v, void* part_i, void* gthr,
                              void* out_v, void* out_i, void* stream) {
  if (B < 1 || B > 32 || N < 1 || d < 4 || d % 4 || d > 1024 || k < 1 ||
      k > KMAX || k > N || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const float*>(q);
  auto cp = static_cast<const float*>(corpus);
  auto pv = static_cast<float*>(part_v);
  auto pi = static_cast<int*>(part_i);
  auto gt = static_cast<int*>(gthr);
  cudaError_t err;
  if (B <= 8)
    err = launch_scan<8>(qp, cp, B, N, d, k, n_blocks, pv, pi, gt, s);
  else if (B <= 16)
    err = launch_scan<16>(qp, cp, B, N, d, k, n_blocks, pv, pi, gt, s);
  else
    err = launch_scan<32>(qp, cp, B, N, d, k, n_blocks, pv, pi, gt, s);
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<B, 32, 0, s>>>(pv, pi, n_blocks, k,
                                static_cast<float*>(out_v),
                                static_cast<int*>(out_i), gt);
  return (int)cudaGetLastError();
}
