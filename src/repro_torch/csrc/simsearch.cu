// Fused cosine top-k for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/simsearch/kernel.py:simsearch
// (pallas_call at :93): normalize the queries and every corpus row in
// fp32, score, and keep a running top-k ordered by (value desc, index
// asc). The (B, N) score matrix never reaches device memory.
//
// What bounds it: at the serving shape (N = 4,194,304 rows, d = 64,
// fp32, B <= 32) the corpus is read once, 1 GiB, about 320 us at
// 3.35 TB/s; the fp32 FMA work 2*B*N*d is about 256 us at B = 32
// against 67 TFLOP/s, so the scan is memory-bound below B ~ 42.
// Design: the TPU grid carried the running top-k from one corpus tile
// to the next; CUDA blocks run in parallel, so here each block walks a
// stride of 256-row tiles and keeps its own top-k in shared memory, and
// a second small kernel merges the per-block lists under the same
// (value desc, index asc) rule. Each thread streams one corpus row at
// a time through registers (16-byte loads, 8 in flight) and scores it
// against all queries of the launch, which sit normalized in shared
// memory and are read as broadcasts. Exact fp32 FMAs: no TF32, no
// bf16. The kernel masks the ragged last tile itself, so the caller
// never pads the corpus.
#include <cuda_runtime.h>
#include <cfloat>
#include <climits>

namespace {

constexpr int TILE = 256;        // corpus rows per tile = threads/block
constexpr int KMAX = 32;
constexpr int CHUNK = 8;         // float4 loads in flight per thread

__device__ __forceinline__ bool better(float v1, int i1, float v2,
                                       int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// Warp-wide best (value desc, index asc) of one candidate per lane.
__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// Select the top-k of the candidates (vals[j], idxs[j]), j < n, by k
// rounds of warp argmax: round r takes the best candidate strictly
// worse than the winner of round r-1 in the (value desc, index asc)
// order, which is total because indices are unique. Rounds that find
// nothing write the sentinel (-FLT_MAX, INT_MAX).
__device__ void warp_select(const float* vals, const int* idxs, int n,
                            int k, float* out_v, int* out_i) {
  const int lane = threadIdx.x & 31;
  float pv = FLT_MAX;
  int pi = -1;
  for (int r = 0; r < k; ++r) {
    float bv = -FLT_MAX;
    int bi = INT_MAX;
    for (int j = lane; j < n; j += 32) {
      float v = vals[j];
      int i = idxs[j];
      if (better(pv, pi, v, i) && better(v, i, bv, bi)) { bv = v; bi = i; }
    }
    warp_best(bv, bi);
    if (lane == 0) { out_v[r] = bv; out_i[r] = bi; }
    pv = bv;
    pi = bi;
  }
}

template <int QB>
__global__ void __launch_bounds__(TILE)
scan_kernel(const float* __restrict__ q, const float* __restrict__ corpus,
            int B, int N, int d, int k, float* __restrict__ part_v,
            int* __restrict__ part_i) {
  extern __shared__ float smem[];
  float* qs = smem;                          // (QB, d) normalized queries
  float* sc = qs + QB * d;                   // (QB, TILE) tile scores
  float* run_v = sc + QB * TILE;             // (QB, KMAX) running top-k
  int* run_i = reinterpret_cast<int*>(run_v + QB * KMAX);
  float* cand_v = reinterpret_cast<float*>(run_i + QB * KMAX);
  int* cand_i = reinterpret_cast<int*>(cand_v + (TILE / 32) *
                                       (TILE + KMAX));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = TILE / 32;

  // normalize the queries once per block: rsqrt(max(sum x^2, 1e-18)),
  // as the TPU kernel does; rows b >= B are zero and never selected
  for (int b = warp; b < QB; b += n_warps) {
    float ss = 0.f;
    for (int j = lane; j < d; j += 32) {
      float x = b < B ? q[(size_t)b * d + j] : 0.f;
      ss = fmaf(x, x, ss);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    float inv = rsqrtf(fmaxf(ss, 1e-18f));
    for (int j = lane; j < d; j += 32)
      qs[b * d + j] = b < B ? q[(size_t)b * d + j] * inv : 0.f;
  }
  for (int j = tid; j < QB * KMAX; j += TILE) {
    run_v[j] = -FLT_MAX;
    run_i[j] = INT_MAX;
  }
  __syncthreads();

  const int n_tiles = (N + TILE - 1) / TILE;
  const int d4 = d >> 2;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int row = t * TILE + tid;
    float acc[QB];
#pragma unroll
    for (int b = 0; b < QB; ++b) acc[b] = 0.f;
    float ss = 0.f;
    if (row < N) {
      const float4* c4 =
          reinterpret_cast<const float4*>(corpus + (size_t)row * d);
      for (int j0 = 0; j0 < d4; j0 += CHUNK) {
        float4 cv[CHUNK];
#pragma unroll
        for (int u = 0; u < CHUNK; ++u)
          cv[u] = j0 + u < d4 ? __ldg(c4 + j0 + u)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
          if (j0 + u >= d4) break;
          const float4 c = cv[u];
          ss = fmaf(c.x, c.x, ss);
          ss = fmaf(c.y, c.y, ss);
          ss = fmaf(c.z, c.z, ss);
          ss = fmaf(c.w, c.w, ss);
#pragma unroll
          for (int b = 0; b < QB; ++b) {
            const float4 qv =
                reinterpret_cast<const float4*>(qs + b * d)[j0 + u];
            float a = acc[b];
            a = fmaf(qv.x, c.x, a);
            a = fmaf(qv.y, c.y, a);
            a = fmaf(qv.z, c.z, a);
            a = fmaf(qv.w, c.w, a);
            acc[b] = a;
          }
        }
      }
    }
    const float inv = rsqrtf(fmaxf(ss, 1e-18f));
#pragma unroll
    for (int b = 0; b < QB; ++b)
      sc[b * TILE + tid] = row < N ? acc[b] * inv : -FLT_MAX;
    __syncthreads();

    // fold this tile into the running top-k: one warp per query row
    const int valid = min(TILE, N - t * TILE);
    float* cv_w = cand_v + warp * (TILE + KMAX);
    int* ci_w = cand_i + warp * (TILE + KMAX);
    for (int b = warp; b < B && b < QB; b += n_warps) {
      for (int j = lane; j < valid; j += 32) {
        cv_w[j] = sc[b * TILE + j];
        ci_w[j] = t * TILE + j;
      }
      for (int j = lane; j < k; j += 32) {
        cv_w[valid + j] = run_v[b * KMAX + j];
        ci_w[valid + j] = run_i[b * KMAX + j];
      }
      __syncwarp();
      warp_select(cv_w, ci_w, valid + k, k, run_v + b * KMAX,
                  run_i + b * KMAX);
      __syncwarp();
    }
    __syncthreads();
  }

  // this block's partial list: part[(b * gridDim.x + block) * k + r]
  for (int j = tid; j < B * k && j < QB * k; j += TILE) {
    const int b = j / k, r = j % k;
    const size_t o = ((size_t)b * gridDim.x + blockIdx.x) * k + r;
    part_v[o] = run_v[b * KMAX + r];
    part_i[o] = run_i[b * KMAX + r];
  }
}

// One warp per query row merges the n_blocks partial lists.
__global__ void merge_kernel(const float* __restrict__ part_v,
                             const int* __restrict__ part_i, int n_blocks,
                             int k, float* __restrict__ out_v,
                             int* __restrict__ out_i) {
  const int b = blockIdx.x;
  const size_t base = (size_t)b * n_blocks * k;
  warp_select(part_v + base, part_i + base, n_blocks * k, k,
              out_v + (size_t)b * k, out_i + (size_t)b * k);
}

size_t scan_smem_bytes(int qb, int d) {
  return sizeof(float) * ((size_t)qb * d + (size_t)qb * TILE +
                          2 * (size_t)qb * KMAX +
                          2 * (size_t)(TILE / 32) * (TILE + KMAX));
}

template <int QB>
cudaError_t launch_scan(const float* q, const float* corpus, int B, int N,
                        int d, int k, int n_blocks, float* part_v,
                        int* part_i, cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(QB, d);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<QB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  scan_kernel<QB><<<n_blocks, TILE, smem, stream>>>(q, corpus, B, N, d, k,
                                                    part_v, part_i);
  return cudaGetLastError();
}

}  // namespace

// queries (B, d) and corpus (N, d) fp32 row-major, d % 4 == 0, B <= 32,
// 1 <= k <= min(32, N). part_v/part_i hold B * n_blocks * k scratch;
// out_v/out_i receive (B, k).
extern "C" int simsearch_topk(const void* q, const void* corpus, int B,
                              int N, int d, int k, int n_blocks,
                              void* part_v, void* part_i, void* out_v,
                              void* out_i, void* stream) {
  if (B < 1 || B > 32 || N < 1 || d < 4 || d % 4 || k < 1 || k > KMAX ||
      k > N || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const float*>(q);
  auto cp = static_cast<const float*>(corpus);
  auto pv = static_cast<float*>(part_v);
  auto pi = static_cast<int*>(part_i);
  cudaError_t err;
  if (B <= 1)
    err = launch_scan<1>(qp, cp, B, N, d, k, n_blocks, pv, pi, s);
  else if (B <= 2)
    err = launch_scan<2>(qp, cp, B, N, d, k, n_blocks, pv, pi, s);
  else if (B <= 4)
    err = launch_scan<4>(qp, cp, B, N, d, k, n_blocks, pv, pi, s);
  else if (B <= 8)
    err = launch_scan<8>(qp, cp, B, N, d, k, n_blocks, pv, pi, s);
  else if (B <= 16)
    err = launch_scan<16>(qp, cp, B, N, d, k, n_blocks, pv, pi, s);
  else
    err = launch_scan<32>(qp, cp, B, N, d, k, n_blocks, pv, pi, s);
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<B, 32, 0, s>>>(pv, pi, n_blocks, k,
                                static_cast<float*>(out_v),
                                static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
