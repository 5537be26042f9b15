// IVF band scan for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/ivf_scan/kernel.py:
// ivf_scan_kernel (pallas_call at :108): for each (query, probed
// cluster), dequantize that cluster's int8 band, score it against the
// normalized query, and keep the top-C candidates by (score desc,
// global row id asc); pad slots (row id -1) score NEG = -2 and absent
// candidates come out as (NEG, -1).
//
// What bounds it: at the serving shape (B = 32 queries, nprobe = 8,
// bands of cap = 672 rows x d = 64 int8 codes + fp32 scale + int32 id)
// the scan reads at most 32 x 8 x 672 x 72 B = 12.4 MB of bands, about
// 3.7 us at 3.35 TB/s; the arithmetic is 22 MFLOP. It is memory- and
// latency-bound, far below both limits at this size.
// Design: the TPU grid ran (query, probe) steps in order and carried
// one running top-C in VMEM from probe to probe; CUDA blocks run in
// parallel and carry nothing. So the scan is two steps:
//   1. one block per (query, probe): each thread scores whole rows of
//      the band (four 16-byte loads of codes per 64-wide row, adjacent
//      threads on adjacent rows), packs (score, id) into one 64-bit key
//      ordered as (score desc, id asc), and the block bitonic-sorts its
//      band's keys in shared memory and writes its best min(C, cap);
//   2. one block per query merges its nprobe sorted lists by the same
//      key order and flushes absent candidates as (NEG, -1).
// Global ids come from row_ids, so ties between bands break exactly as
// in the reference. Scores accumulate in fp64 (see ivf_band.cuh), which
// makes the selection independent of summation order. Later steps:
// cluster-grouped dispatch (queries that probe the same cluster share
// one band load), cp.async/TMA staging of the bands, a top-C select
// that does not sort the whole band.
#include "ivf_band.cuh"

namespace {

using namespace ivf_band;

__global__ void __launch_bounds__(THREADS)
probe_kernel(const float* __restrict__ q, const int* __restrict__ cids,
             const int8_t* __restrict__ codes,
             const float* __restrict__ scales,
             const int* __restrict__ row_ids, int nprobe, int cap, int d,
             int c_blk, unsigned long long* __restrict__ part) {
  extern __shared__ unsigned long long smem[];   // band keys, then q
  const int b = blockIdx.x / nprobe, p = blockIdx.x % nprobe;
  double* qs = reinterpret_cast<double*>(smem + pow2_at_least(cap));
  load_query(q + (size_t)b * d, d, qs);
  __syncthreads();
  const size_t cl = (size_t)cids[(size_t)b * nprobe + p];
  score_band<int8_t>(codes + cl * cap * d, scales + cl * cap,
                     row_ids + cl * cap, cap, d, qs, smem, c_blk,
                     part + ((size_t)b * nprobe + p) * c_blk);
}

__global__ void __launch_bounds__(THREADS)
merge_kernel(const unsigned long long* __restrict__ part, int nprobe,
             int c_blk, int C, float* __restrict__ out_v,
             int* __restrict__ out_i) {
  extern __shared__ unsigned long long smem[];
  const size_t b = blockIdx.x;
  merge_lists(part + b * nprobe * c_blk, nprobe, c_blk, C, smem,
              out_v + b * C, out_i + b * C);
}

}  // namespace

// q (B, d) fp32 L2-normalized rows; cids (B, nprobe) int32 cluster ids
// in [0, K); codes (K, cap, d) int8; scales (K, cap) fp32; row_ids
// (K, cap) int32 (-1 = pad). d % 16 == 0, 1 <= C <= nprobe * cap.
// part holds B * nprobe * min(C, cap) uint64 scratch; out_v / out_i
// receive (B, C).
extern "C" int ivf_scan_topc(const void* q, const void* cids,
                             const void* codes, const void* scales,
                             const void* row_ids, int B, int nprobe,
                             int cap, int d, int C, void* part,
                             void* out_v, void* out_i, void* stream) {
  if (B < 1 || nprobe < 1 || cap < 1 || d < 16 || d % 16 || C < 1 ||
      C > nprobe * cap)
    return (int)cudaErrorInvalidValue;
  const int c_blk = C < cap ? C : cap;
  const size_t smem_probe = sizeof(unsigned long long) * pow2_at_least(cap)
                            + sizeof(double) * d;
  const size_t smem_merge =
      sizeof(unsigned long long) * pow2_at_least(nprobe * c_blk);
  auto s = static_cast<cudaStream_t>(stream);
  auto pp = static_cast<unsigned long long*>(part);
  cudaError_t err = allow_smem((const void*)probe_kernel, smem_probe);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem((const void*)merge_kernel, smem_merge);
  if (err != cudaSuccess) return (int)err;
  probe_kernel<<<B * nprobe, THREADS, smem_probe, s>>>(
      static_cast<const float*>(q), static_cast<const int*>(cids),
      static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
      static_cast<const int*>(row_ids), nprobe, cap, d, c_blk, pp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<B, THREADS, smem_merge, s>>>(
      pp, nprobe, c_blk, C, static_cast<float*>(out_v),
      static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
