// Embedding bag (gather + weighted reduce) for Hopper (sm_90a), plain C
// interface.
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
// On Wide&Deep's path (d = 32 fp32 deep table, 4,001,792 rows; m = 4)
// a bag reads four 128 B rows and writes one, so at serve_bulk (10.5 M
// bags) the gathered rows are 5.4 GB while the distinct rows are at
// most the 512 MB table: the L2 (50 MB) cannot hold the table, so
// repeated rows are mostly re-read from HBM.
// Design: one thread per (bag, output column), with the columns of one
// bag on adjacent threads. At d = 32 a warp is one bag: each j is one
// broadcast load of the id and the weight and one coalesced 128 B row
// load. At d = 1 (the wide table) a warp covers 32 bags and reads one
// 4 B word out of each 32 B sector, so that call moves ~8x the useful
// bytes; it is left so in this first version. The ids and weights of
// four j are loaded before their rows, so each thread keeps four
// independent row loads in flight. Offsets are 64-bit (at serve_bulk
// B * d = 335 M outputs and V * d = 128 M table words). Each step rounds
// the product and the sum separately (__fmul_rn / __fadd_rn, which nvcc
// never contracts into an FMA), the rounding of the plain PyTorch
// version's eager `acc + w * row`, so the two agree bit for bit.
// Later steps: a warp per bag with vector loads at small d, rows staged
// through shared memory by TMA gathers, the deep and wide tables in one
// launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bag_kernel(const T* __restrict__ table, const int* __restrict__ ids,
           const float* __restrict__ w, long long total, int m, int d,
           float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long b = t / d;
    const int c = (int)(t - b * d);
    const int* ib = ids + b * m;
    const float* wb = w + b * m;
    float acc = 0.f;
    int j = 0;
    for (; j + UNROLL <= m; j += UNROLL) {
      int id[UNROLL];
      float wt[UNROLL], v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        id[u] = ib[j + u];
        wt[u] = wb[j + u];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        v[u] = to_f32(table[(long long)id[u] * d + c]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        acc = __fadd_rn(acc, __fmul_rn(wt[u], v[u]));
    }
    for (; j < m; ++j)
      acc = __fadd_rn(acc, __fmul_rn(wb[j],
                                     to_f32(table[(long long)ib[j] * d + c])));
    out[t] = acc;
  }
}

template <typename T>
int launch(const void* table, const void* ids, const void* w, void* out,
           int B, int m, int d, cudaStream_t s) {
  const long long total = (long long)B * d;
  const long long want = (total + THREADS - 1) / THREADS;
  const int blocks = (int)(want < (1LL << 30) ? want : (1LL << 30));
  bag_kernel<T><<<blocks, THREADS, 0, s>>>(
      static_cast<const T*>(table), static_cast<const int*>(ids),
      static_cast<const float*>(w), total, m, d, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// table (V, d) fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1); ids (B, m)
// int32, each in [0, V) (the caller's contract); w (B, m) fp32; out
// (B, d) fp32. B >= 1, m >= 0, d >= 1.
extern "C" int embedding_bag_fwd(const void* table, const void* ids,
                                 const void* w, void* out, int B, int m,
                                 int d, int is_bf16, void* stream) {
  if (B < 1 || m < 0 || d < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(table, ids, w, out, B, m, d, s)
                 : launch<float>(table, ids, w, out, B, m, d, s);
}
