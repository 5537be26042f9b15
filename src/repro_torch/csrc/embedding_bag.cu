// Embedding bag (gather + weighted reduce) for Hopper (sm_90a), plain C
// interface, and its backward (the table's gradient, each row written
// once: see embedding_bag_bwd below).
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/kernel.py:
// embedding_bag (pallas_call at :50):
//   out[b, c] = sum_j w[b, j] * table[ids[b, j], c]
// accumulated in fp32 over j in order, starting from 0. The TPU kernel
// walked a (B, m) grid in order, DMA-ing one table row per step into
// VMEM while the (1, d) output block stayed resident across a bag's m
// steps.
//
// What bounds it: bytes. Each (bag, id) pair reads one d-wide row at a
// data-dependent address and does 2d flops on it, so the work is about
// 0.5 flop per byte read: far below the H100's fp32 ridge (~20 flop/B).
// On Wide&Deep's path (d = 32 fp32 deep table, 4,001,792 rows, 40
// fields of 100,000; m = 4) serve_bulk gathers 5.4 GB of rows out of a
// 512 MB table and writes 1.34 GB, so what the call costs is how often
// a row comes from HBM rather than from the 50 MB L2, and how few
// instructions a bag takes.
// Design:
//  - A sub-warp of LPB = ceil(d / VEC) lanes (rounded to a power of
//    two) carries one bag, each lane VEC columns by one 16-byte load
//    (4 fp32 or 8 bf16 values; 1 value where d does not divide), so a
//    warp carries 32 / LPB bags: four at the deep d = 32, 32 at the
//    wide d = 1, where a lane is a bag and the lanes' ids, weights and
//    outputs are neighbours.
//  - Each lane reads its bag's ids and weights four at a time, one
//    16-byte load each where m % 4 == 0 (the sub-warp's lanes ask for
//    the same bytes, which L1 serves once), then issues the four row
//    loads before it uses any. Shuffling the ids out from one lane, or
//    carrying two or four bags a sub-warp to keep 8-16 gathers in
//    flight, measured slower on the H100 at serve_bulk: occupancy
//    already hides the two dependent trips (ids, then rows), and what
//    is left is instructions.
//  - Blocks map to bags without a division: blockIdx.y picks the
//    groups, blockIdx.x a run of rows within them. When the caller
//    names groups (Wide&Deep's fields: bag b * F + f belongs to field
//    f) and the table and the gathered rows both exceed half the L2
//    (the wrapper decides), a block's bags come from two neighbouring
//    fields and the blocks run field pair by field pair: the blocks
//    resident at once then gather from 25.6 MB of rows that stay in
//    L2, so each row comes from HBM about once a pass instead of once
//    a gather, and a bag's ids share a 32-byte sector with its
//    neighbour field's. Otherwise the bags run in order, where ids,
//    weights and outputs are contiguous. ids, weights and outputs are
//    streamed past L2 (ld/st .cs) so they do not evict table rows.
//  - Offsets are 64-bit (at serve_bulk B * d = 335 M outputs and V * d
//    = 128 M table words).
// Each step rounds the product and the sum separately (__fmul_rn /
// __fadd_rn, which nvcc never contracts into an FMA), the rounding of
// the plain PyTorch version's eager `acc + w * row`, in j order for
// every output column, so the two agree bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int J = 4;             // ids (and row gathers) a lane a step

__device__ __forceinline__ void load_row(const float* p, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load_row(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&v)[8]) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[2 * e] = __uint_as_float(w[e] << 16);              // low bf16
    v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);  // high bf16
  }
}
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&v)[1]) {
  v[0] = __bfloat162float(p[0]);
}

template <int VEC>
__device__ __forceinline__ void store_out(float* p, const float (&a)[VEC]) {
  if constexpr (VEC == 1) {
    __stcs(p, a[0]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      __stcs(reinterpret_cast<float4*>(p + e),
             make_float4(a[e], a[e + 1], a[e + 2], a[e + 3]));
  }
}

// Block (x, y) takes rows r = x * PER_BLOCK, ... of the 2^span_log2
// groups from y * 2^span_log2 on (groups = gridDim.y << span_log2):
// row r is bag (r >> span_log2) * groups + (y << span_log2) + the low
// span_log2 bits of r. With one group it is bag r.
template <typename T, int VEC, int LPB, bool V4>
__global__ void __launch_bounds__(THREADS)
bag_kernel(const T* __restrict__ table, const int* __restrict__ ids,
           const float* __restrict__ w, int rows, int m, int d,
           int span_log2, float* __restrict__ out) {
  constexpr int SPW = 32 / LPB;               // bags a warp carries
  constexpr int PER_BLOCK = THREADS / 32 * SPW;
  const int lane = threadIdx.x & 31, sl = lane % LPB;
  const int groups = gridDim.y << span_log2;
  const int r = blockIdx.x * PER_BLOCK + (threadIdx.x >> 5) * SPW +
                lane / LPB;
  const bool live = r < rows;
  const int bag = (r >> span_log2) * groups + (blockIdx.y << span_log2) +
                  (r & ((1 << span_log2) - 1));
  const int* ib = ids + (size_t)bag * m;
  const float* wb = w + (size_t)bag * m;
  for (int c0 = 0; c0 < d; c0 += LPB * VEC) {
    const int col = c0 + sl * VEC;
    const bool cok = live && col < d;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int j0 = 0; j0 < m; j0 += J) {
      int id[J];
      float wt[J];
      if constexpr (V4) {                    // m % 4 == 0, aligned
        const int4 iv = live ? __ldcs(reinterpret_cast<const int4*>(
                                   ib + j0)) : make_int4(0, 0, 0, 0);
        const float4 wv = live ? __ldcs(reinterpret_cast<const float4*>(
                                     wb + j0))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        id[0] = iv.x; id[1] = iv.y; id[2] = iv.z; id[3] = iv.w;
        wt[0] = wv.x; wt[1] = wv.y; wt[2] = wv.z; wt[3] = wv.w;
      } else {
#pragma unroll
        for (int u = 0; u < J; ++u) {
          const bool ok = live && j0 + u < m;
          id[u] = ok ? __ldcs(ib + j0 + u) : 0;
          wt[u] = ok ? __ldcs(wb + j0 + u) : 0.f;
        }
      }
      float v[J][VEC];
#pragma unroll
      for (int u = 0; u < J; ++u) {
        if (cok && j0 + u < m) {
          load_row(table + (size_t)id[u] * d + col, v[u]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < J; ++u) {
        if (j0 + u >= m) break;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(wt[u], v[u][e]));
      }
    }
    if (cok) store_out<VEC>(out + (size_t)bag * d + col, acc);
  }
}

template <typename T, int VEC, int LPB>
int launch_lpb(const void* table, const void* ids, const void* w,
               void* out, int B, int m, int d, int groups, int span_log2,
               bool v4, cudaStream_t s) {
  constexpr long long PER_BLOCK = THREADS / 32 * (32 / LPB);
  const int rows = B / groups << span_log2;   // bags of one grid row
  const dim3 grid((unsigned)((rows + PER_BLOCK - 1) / PER_BLOCK),
                  (unsigned)(groups >> span_log2));
  auto tp = static_cast<const T*>(table);
  auto ip = static_cast<const int*>(ids);
  auto wp = static_cast<const float*>(w);
  auto op = static_cast<float*>(out);
  if (v4)
    bag_kernel<T, VEC, LPB, true><<<grid, THREADS, 0, s>>>(
        tp, ip, wp, rows, m, d, span_log2, op);
  else
    bag_kernel<T, VEC, LPB, false><<<grid, THREADS, 0, s>>>(
        tp, ip, wp, rows, m, d, span_log2, op);
  return (int)cudaGetLastError();
}

// lanes per bag: ceil(d / VEC) rounded up to a power of two, at most 32
template <typename T, int VEC>
int launch_vec(const void* t, const void* i, const void* w, void* o, int B,
               int m, int d, int g, int sp, bool v4, cudaStream_t s) {
  const int need = (d + VEC - 1) / VEC;
  if (need <= 1) return launch_lpb<T, VEC, 1>(t, i, w, o, B, m, d, g, sp,
                                              v4, s);
  if (need <= 2) return launch_lpb<T, VEC, 2>(t, i, w, o, B, m, d, g, sp,
                                              v4, s);
  if (need <= 4) return launch_lpb<T, VEC, 4>(t, i, w, o, B, m, d, g, sp,
                                              v4, s);
  if (need <= 8) return launch_lpb<T, VEC, 8>(t, i, w, o, B, m, d, g, sp,
                                              v4, s);
  if (need <= 16) return launch_lpb<T, VEC, 16>(t, i, w, o, B, m, d, g,
                                                sp, v4, s);
  return launch_lpb<T, VEC, 32>(t, i, w, o, B, m, d, g, sp, v4, s);
}

template <typename T>
int launch(const void* table, const void* ids, const void* w, void* out,
           int B, int m, int d, int groups, int span_log2, cudaStream_t s) {
  constexpr int VEC = 16 / (int)sizeof(T);   // one 16-byte load a lane
  const bool vec = d % VEC == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0;
  const bool v4 = m % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(ids) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return vec ? launch_vec<T, VEC>(table, ids, w, out, B, m, d, groups,
                                  span_log2, v4, s)
             : launch_vec<T, 1>(table, ids, w, out, B, m, d, groups,
                                span_log2, v4, s);
}

// ---------------------------------------------------------------------
// Backward: the table's gradient, written once a row, no atomics.
//
// Replaces no TPU kernel: the JAX package differentiates its jnp bag
// (src/repro/models/recsys.py:42-51, jax.ops.segment_sum), which XLA
// lowers to a scatter-add. It computes
//   g[r, c] = sum over (b, j) with ids[b, j] = r of w[b, j] * grad[b, c]
// in fp32, shape (V, d). A scatter-add on the card (index_add_) adds a
// row's terms by atomics, in an order that changes from run to run, so
// two runs on the same inputs differ in the last bits.
//
// Design: the wrapper sorts the flat ids stably on the card (index
// preparation: keys, and the flat positions b * m + j in ascending order
// within each run of equal keys). A sub-warp of LPB lanes, as in the
// forward, owns one gradient row r: it finds the run of r in the sorted
// keys by a binary search (lower_bound), adds the run's terms in
// ascending flat position, one fp32 multiply and one fp32 add a step
// (__fmul_rn / __fadd_rn, the rounding of the plain version's
// `w * grad` then `index_add_`), and writes the row once; a row that no
// id names is written as zeros. So every row is written exactly once
// and two launches on the same inputs are bit-identical.
//
// What bounds it: bytes. Each input is read once (grad (B, d), ids and
// weights (B, m)) and the (V, d) gradient is written once; at
// Wide&Deep's train_batch the 512 MB gradient of the 4,001,792 x 32
// table dominates. The sort's passes over the ids and the positions,
// and the search's reads of the keys (which stay in L2 at that size),
// come on top.
template <int VEC, int LPB>
__global__ void __launch_bounds__(THREADS)
bag_bwd_kernel(const float* __restrict__ grad, const int* __restrict__ keys,
               const long long* __restrict__ pos,
               const float* __restrict__ w, int n, int m, int d, int V,
               float* __restrict__ out) {
  constexpr int SPW = 32 / LPB;               // rows a warp carries
  constexpr int PER_BLOCK = THREADS / 32 * SPW;
  const int lane = threadIdx.x & 31, sl = lane % LPB;
  const int r = blockIdx.x * PER_BLOCK + (threadIdx.x >> 5) * SPW +
                lane / LPB;
  if (r >= V) return;                         // no warp-wide sync below
  int lo = 0, hi = n;                         // first key >= r
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    if (__ldg(keys + mid) < r) lo = mid + 1; else hi = mid;
  }
  for (int c0 = 0; c0 < d; c0 += LPB * VEC) {
    const int col = c0 + sl * VEC;
    if (col >= d) break;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int q = lo; q < n && __ldg(keys + q) == r; ++q) {
      const long long p = __ldg(pos + q);
      const float wt = __ldg(w + p);
      float v[VEC];
      load_row(grad + (size_t)(p / m) * d + col, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[e] = __fadd_rn(acc[e], __fmul_rn(wt, v[e]));
    }
    store_out<VEC>(out + (size_t)r * d + col, acc);
  }
}

template <int VEC, int LPB>
int launch_bwd_lpb(const void* grad, const void* keys, const void* pos,
                   const void* w, void* out, int n, int m, int d, int V,
                   cudaStream_t s) {
  constexpr long long PER_BLOCK = THREADS / 32 * (32 / LPB);
  const unsigned blocks = (unsigned)((V + PER_BLOCK - 1) / PER_BLOCK);
  bag_bwd_kernel<VEC, LPB><<<blocks, THREADS, 0, s>>>(
      static_cast<const float*>(grad), static_cast<const int*>(keys),
      static_cast<const long long*>(pos), static_cast<const float*>(w), n,
      m, d, V, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

template <int VEC>
int launch_bwd_vec(const void* g, const void* k, const void* p,
                   const void* w, void* o, int n, int m, int d, int V,
                   cudaStream_t s) {
  const int need = (d + VEC - 1) / VEC;
  if (need <= 1) return launch_bwd_lpb<VEC, 1>(g, k, p, w, o, n, m, d, V, s);
  if (need <= 2) return launch_bwd_lpb<VEC, 2>(g, k, p, w, o, n, m, d, V, s);
  if (need <= 4) return launch_bwd_lpb<VEC, 4>(g, k, p, w, o, n, m, d, V, s);
  if (need <= 8) return launch_bwd_lpb<VEC, 8>(g, k, p, w, o, n, m, d, V, s);
  if (need <= 16)
    return launch_bwd_lpb<VEC, 16>(g, k, p, w, o, n, m, d, V, s);
  return launch_bwd_lpb<VEC, 32>(g, k, p, w, o, n, m, d, V, s);
}

}  // namespace

// grad (B, d) fp32; keys (n,) int32, the flat ids (n = B * m) sorted
// ascending, each in [0, V); pos (n,) int64, the flat position b * m + j
// of each key, ascending within a run of equal keys (a stable sort);
// w (B, m) fp32; out (V, d) fp32. V, d >= 1; m >= 1 when n > 0. Every
// row of out is written once.
extern "C" int embedding_bag_bwd(const void* grad, const void* keys,
                                 const void* pos, const void* w, void* out,
                                 int n, int m, int d, int V, void* stream) {
  if (V < 1 || d < 1 || n < 0 || (n > 0 && m < 1))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(grad) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec ? launch_bwd_vec<4>(grad, keys, pos, w, out, n, m, d, V, s)
             : launch_bwd_vec<1>(grad, keys, pos, w, out, n, m, d, V, s);
}

// table (V, d) fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1); ids (B, m)
// int32, each in [0, V) (the caller's contract); w (B, m) fp32; out
// (B, d) fp32, 16-byte aligned. B >= 1, m >= 0, d >= 1. groups >= 1
// divides B and names bag b * groups + g's group g: the bags then run
// group by group, two groups a pass when groups is even, which changes
// no output bit (groups = 1: bag order).
extern "C" int embedding_bag_fwd(const void* table, const void* ids,
                                 const void* w, void* out, int B, int m,
                                 int d, int is_bf16, int groups,
                                 void* stream) {
  if (B < 1 || m < 0 || d < 1 || groups < 1 || B % groups ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const int span_log2 = groups % 2 == 0 ? 1 : 0;
  if ((groups >> span_log2) > 65535) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(table, ids, w, out, B, m, d,
                                         groups, span_log2, s)
                 : launch<float>(table, ids, w, out, B, m, d, groups,
                                 span_log2, s);
}
