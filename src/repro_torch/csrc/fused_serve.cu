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
// about 3.7 us at 3.35 TB/s. Latency sets the time, as for the band
// scan (ivf_band.cuh).
// Design (ivf_band.cuh): the TPU kernel walked each query's bands and
// tiles in order through a two-slot DMA double buffer, carrying two
// running top lists in VMEM. Here a cluster of up to 8 blocks owns a
// query and shares its units: first slices of the tier, one for each
// block (64 rows of a 512-slot tier), then the nprobe bands. Each block
// stages both of its units by TMA at once, scores its tier slice while
// its band is still in flight (bf16 widened exactly, fp64 sums), keeps
// a running list per tier, and writes both lists into the shared memory
// of the cluster's last block, which merges them and writes the
// outputs. One launch, no scratch in device memory.
#include "ivf_band.cuh"

// q (B, d) fp32 L2-normalized; cids (B, nprobe) int32 in [0, K); codes
// (K, cap, d) int8; scales (K, cap) fp32; row_ids (K, cap) int32 (-1 =
// pad); tiles (n_tiles, tile, d) bf16; tile_ids (n_tiles, tile) int32
// (-1 = invalid or pad slot); codes and tiles 16-byte aligned.
// d % 16 == 0, 1 <= C <= nprobe * cap, 1 <= Cd <= n_tiles * tile;
// outputs (B, C) and (B, Cd).
extern "C" int fused_serve_topc(const void* q, const void* cids,
                                const void* codes, const void* scales,
                                const void* row_ids, const void* tiles,
                                const void* tile_ids, int B, int nprobe,
                                int cap, int n_tiles, int tile, int d,
                                int C, int Cd, void* sv, void* si,
                                void* dv, void* di, void* stream) {
  using namespace ivf_band;
  if (B < 1 || nprobe < 1 || cap < 1 || n_tiles < 1 || tile < 1 ||
      d < 16 || d % 16 || C < 1 || C > nprobe * cap || Cd < 1 ||
      Cd > n_tiles * tile)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = static_cast<const float*>(q);
  p.d = d;
  p.n_src = 2;
  // the tier's rows spread over a whole cluster, first: each block
  // scores its slice of the tier while its band is still in flight
  p.src[0] = make_source(tiles, nullptr, static_cast<const int*>(tile_ids),
                         nullptr, n_tiles, tile, 2 * d, Cd,
                         (MAX_CLUSTER + n_tiles - 1) / n_tiles,
                         static_cast<float*>(dv), static_cast<int*>(di));
  p.src[1] = make_source(codes, static_cast<const float*>(scales),
                         static_cast<const int*>(row_ids),
                         static_cast<const int*>(cids), nprobe, cap, d, C,
                         1, static_cast<float*>(sv), static_cast<int*>(si));
  return (int)launch(p, B, static_cast<cudaStream_t>(stream));
}
