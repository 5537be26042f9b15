// Fused two-tier probe for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/fused_serve/kernel.py:
// fused_serve_kernel (pallas_call at :193): one dispatch per
// micro-batch scores BOTH tiers for every query -- the static tier's
// probed int8 IVF bands (the ivf_scan band scan) and the dynamic tier's
// bf16 tiles with invalid slots masked -- and emits two candidate
// lists, the static top-C (score desc, global row id asc) and the
// dynamic top-Cd (score desc, slot asc), absent candidates as (NEG, -1).
// The exact fp32 reranks of both lists run after it, in PyTorch.
//
// What bounds it: at the serving shape (B = 32, nprobe = 8, bands of
// 672 x 64 int8 + scale + id; a 512-slot dynamic tier of 64-wide bf16
// rows + ids) it reads at most 12.4 MB of bands and 66 KB of tier,
// about 3.7 us at 3.35 TB/s. Memory- and latency-bound.
// Design: the TPU kernel walked each query's bands and tiles in order
// through a manual two-slot DMA double buffer, carrying two running
// top lists in VMEM. Here one launch holds a block for every (query,
// band) and every (query, tier tile) pair: each block scores its rows
// into (score, id) keys and bitonic-sorts them in shared memory (the
// shared code of ivf_band.cuh), writing its best min(C, cap) or
// min(Cd, tile) keys. A second, small launch inside the same wrapper
// call merges each query's static lists and dynamic lists by the same
// key order (a block's lists cannot be merged without a grid-wide
// barrier). The query row is loaded once per block into shared memory.
// Tier values are bf16 widened exactly, scores accumulate in fp64 (see
// ivf_band.cuh). Later steps: cp.async/TMA staging of bands and tiles
// (the TPU kernel's double buffer), cluster-grouped dispatch, and a
// top-C select that does not sort every row.
#include "ivf_band.cuh"

namespace {

using namespace ivf_band;

__global__ void __launch_bounds__(THREADS)
probe_kernel(const float* __restrict__ q, const int* __restrict__ cids,
             const int8_t* __restrict__ codes,
             const float* __restrict__ scales,
             const int* __restrict__ row_ids,
             const __nv_bfloat16* __restrict__ tiles,
             const int* __restrict__ tile_ids, int nprobe, int cap,
             int n_tiles, int tile, int d, int c_blk, int cd_blk,
             unsigned long long* __restrict__ part_s,
             unsigned long long* __restrict__ part_d) {
  extern __shared__ unsigned long long smem[];   // keys, then q
  const int per = nprobe + n_tiles;
  const int b = blockIdx.x / per, j = blockIdx.x % per;
  const int rows = cap > tile ? cap : tile;
  double* qs = reinterpret_cast<double*>(smem + pow2_at_least(rows));
  load_query(q + (size_t)b * d, d, qs);
  __syncthreads();
  if (j < nprobe) {
    const size_t cl = (size_t)cids[(size_t)b * nprobe + j];
    score_band<int8_t>(codes + cl * cap * d, scales + cl * cap,
                       row_ids + cl * cap, cap, d, qs, smem, c_blk,
                       part_s + ((size_t)b * nprobe + j) * c_blk);
  } else {
    const size_t t = j - nprobe;
    score_band<__nv_bfloat16>(tiles + t * tile * d, nullptr,
                              tile_ids + t * tile, tile, d, qs, smem,
                              cd_blk,
                              part_d + ((size_t)b * n_tiles + t) * cd_blk);
  }
}

__global__ void __launch_bounds__(THREADS)
merge_kernel(const unsigned long long* __restrict__ part_s,
             const unsigned long long* __restrict__ part_d, int nprobe,
             int c_blk, int C, int n_tiles, int cd_blk, int Cd,
             float* __restrict__ sv, int* __restrict__ si,
             float* __restrict__ dv, int* __restrict__ di) {
  extern __shared__ unsigned long long smem[];
  const size_t b = blockIdx.x;
  merge_lists(part_s + b * nprobe * c_blk, nprobe, c_blk, C, smem,
              sv + b * C, si + b * C);
  __syncthreads();      // the static outputs are read out of smem first
  merge_lists(part_d + b * n_tiles * cd_blk, n_tiles, cd_blk, Cd, smem,
              dv + b * Cd, di + b * Cd);
}

}  // namespace

// q (B, d) fp32 L2-normalized; cids (B, nprobe) int32 in [0, K); codes
// (K, cap, d) int8; scales (K, cap) fp32; row_ids (K, cap) int32 (-1 =
// pad); tiles (n_tiles, tile, d) bf16; tile_ids (n_tiles, tile) int32
// (-1 = invalid or pad slot). d % 16 == 0, 1 <= C <= nprobe * cap,
// 1 <= Cd <= n_tiles * tile. part_s / part_d hold B * nprobe *
// min(C, cap) and B * n_tiles * min(Cd, tile) uint64 scratch; outputs
// (B, C) and (B, Cd).
extern "C" int fused_serve_topc(const void* q, const void* cids,
                                const void* codes, const void* scales,
                                const void* row_ids, const void* tiles,
                                const void* tile_ids, int B, int nprobe,
                                int cap, int n_tiles, int tile, int d,
                                int C, int Cd, void* part_s, void* part_d,
                                void* sv, void* si, void* dv, void* di,
                                void* stream) {
  if (B < 1 || nprobe < 1 || cap < 1 || n_tiles < 1 || tile < 1 ||
      d < 16 || d % 16 || C < 1 || C > nprobe * cap || Cd < 1 ||
      Cd > n_tiles * tile)
    return (int)cudaErrorInvalidValue;
  const int c_blk = C < cap ? C : cap;
  const int cd_blk = Cd < tile ? Cd : tile;
  const int rows = cap > tile ? cap : tile;
  const int lists = nprobe * c_blk > n_tiles * cd_blk ? nprobe * c_blk
                                                      : n_tiles * cd_blk;
  const size_t smem_probe =
      sizeof(unsigned long long) * pow2_at_least(rows) + sizeof(double) * d;
  const size_t smem_merge =
      sizeof(unsigned long long) * pow2_at_least(lists);
  auto s = static_cast<cudaStream_t>(stream);
  auto ps = static_cast<unsigned long long*>(part_s);
  auto pd = static_cast<unsigned long long*>(part_d);
  cudaError_t err = allow_smem((const void*)probe_kernel, smem_probe);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem((const void*)merge_kernel, smem_merge);
  if (err != cudaSuccess) return (int)err;
  probe_kernel<<<B * (nprobe + n_tiles), THREADS, smem_probe, s>>>(
      static_cast<const float*>(q), static_cast<const int*>(cids),
      static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
      static_cast<const int*>(row_ids),
      static_cast<const __nv_bfloat16*>(tiles),
      static_cast<const int*>(tile_ids), nprobe, cap, n_tiles, tile, d,
      c_blk, cd_blk, ps, pd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<B, THREADS, smem_merge, s>>>(
      ps, pd, nprobe, c_blk, C, n_tiles, cd_blk, Cd,
      static_cast<float*>(sv), static_cast<int*>(si),
      static_cast<float*>(dv), static_cast<int*>(di));
  return (int)cudaGetLastError();
}
