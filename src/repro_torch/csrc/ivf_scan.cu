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
// 3.7 us at 3.35 TB/s; the arithmetic is 22 MFLOP. Latency sets the
// time: the bands' arrival, then the SMs' instruction issue for scoring
// and selection, each SM carrying up to three blocks (ivf_band.cuh).
// Design (ivf_band.cuh): the TPU grid walked a query's probes in order,
// a two-slot DMA double buffer staging the next band while it scored
// one and one running top-C carried in VMEM. Here a cluster of
// min(nprobe x units a band, 8) blocks owns a query: each block stages
// its bands whole by TMA, all in flight at once (a two-stage ring when
// it has more than two), scores them from shared memory in fp64 and
// keeps its running top-C by a score-binned threshold and a rank of the
// few survivors; every block then writes its list into the shared
// memory of the cluster's last block, which merges the lists and writes
// the outputs. One launch, no scratch in device memory.
#include "ivf_band.cuh"

// q (B, d) fp32 L2-normalized rows; cids (B, nprobe) int32 cluster ids
// in [0, K); codes (K, cap, d) int8 (16-byte aligned); scales (K, cap)
// fp32; row_ids (K, cap) int32 (-1 = pad). d % 16 == 0,
// 1 <= C <= nprobe * cap. out_v / out_i receive (B, C).
extern "C" int ivf_scan_topc(const void* q, const void* cids,
                             const void* codes, const void* scales,
                             const void* row_ids, int B, int nprobe,
                             int cap, int d, int C, void* out_v,
                             void* out_i, void* stream) {
  using namespace ivf_band;
  if (B < 1 || nprobe < 1 || cap < 1 || d < 16 || d % 16 || C < 1 ||
      C > nprobe * cap)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = static_cast<const float*>(q);
  p.d = d;
  p.n_src = 1;
  p.src[0] = make_source(codes, static_cast<const float*>(scales),
                         static_cast<const int*>(row_ids),
                         static_cast<const int*>(cids), nprobe, cap, d, C,
                         1, static_cast<float*>(out_v),
                         static_cast<int*>(out_i));
  return (int)launch(p, B, static_cast<cudaStream_t>(stream));
}
