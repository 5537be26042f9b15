// Causal GQA prefill attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention
// (pallas_call at :84): online softmax over kv tiles, fp32 statistics
// and accumulation, kv tiles past the causal frontier skipped, kv head
// = q head / G, each K/V tile fetched once per group of G heads.
//
// What bounds it: at the serving prefill (B = 8, S ~ 40-64 tokens,
// H = 16, K = 8, D = 128, bf16) the inputs are ~4 MB, ~1.9 us at
// 3.35 TB/s, and the call is bound by latency (launch, one round trip
// to HBM, a handful of tile steps). At long S the 4*B*H*D*S^2/2
// causal operations bound it: ~4.1 GFLOP at B = 1, S = 1000, ~4 us at
// the 989 TFLOP/s bf16 peak.
// Design (bf16): one block owns (q tile, kv head, batch) and carries
// the tile's positions for all G query heads of that kv head as its 64
// rows (64 / G positions; row = position * G + head), four warps of 16
// rows. Each K/V tile is thus staged once per group, as the TPU kernel
// fetched it. K/V tiles of 64 keys stay bf16 in shared memory, in a
// ring of three stages filled by cp.async (tiles t + 1 and t + 2 in
// flight while t is computed, one barrier a tile), rows padded by 16
// bytes so ldmatrix is free of bank conflicts.
// S = Q K^T and O += P V run on the tensor cores (mma.sync m16n8k16,
// bf16 in, fp32 accumulators); the online softmax runs in registers in
// the accumulator layout (FlashAttention-2), and P is rounded to bf16
// for the P V product. The causal mask is applied only on tiles that
// cross a warp's diagonal or the end of the sequence, and a warp skips
// the tiles past its last position. Causal q tiles differ in work (the
// last holds S / 64 kv tiles, the first one): blocks start longest
// first, and when the grid would have more blocks than the card has
// SMs, one block takes a long and a short q tile (x and n - 1 - x), so
// all blocks carry about the same number of kv tiles.
// Any S is taken: the ragged last q and kv tiles are masked (copies
// past S are zero-filled), which the TPU kernel's S % bq == 0 assert
// did not allow. At long S (B = 1, S = 1000) the kernel still trails
// the library's flash attention: one block of four warps a SM runs its
// ~17 kv tiles at a fraction of the mma.sync rate. The next step there
// is wgmma (64-row warpgroup tiles fed by TMA, two consumer warpgroups
// a block), which mma.sync cannot reach; at the serving shape the call
// is latency-bound and wgmma would not move it.
// fp32: exact fp32 FMAs on CUDA cores, one block per (16-row q tile,
// q head, batch), K/V tiles of 32 keys widened into shared memory.
#include "attn_mma.cuh"

namespace {

constexpr int THREADS = 128;
constexpr float NEG = -1e30f;

// ---- bf16: tensor cores -------------------------------------------------

constexpr int ROWS = 64;         // (position, head) rows per block
constexpr int BKV = 64;          // keys per kv tile
constexpr int STAGES = 3;        // kv tiles in shared memory

// One q tile (positions q0 .. q0 + 64/G - 1, all G heads of kv head kh,
// sequence b) against the kv tiles up to its causal frontier.
template <int D>
__device__ __forceinline__ void flash_tile(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int S, int H, int K, int G, float scale_log2, int q0, int kh, int b,
    __nv_bfloat16* qs, __nv_bfloat16* ks, __nv_bfloat16* vs) {
  constexpr int LD = D + 8;                    // padded row, elements
  constexpr int CPR = D / 8;                   // 16-byte copies per row
  const int BQ = ROWS / G;                     // positions per block
  const int n_rows = BQ * G;                   // rows in use
  const int q_end = min(q0 + BQ, S);
  const int n_tiles = (q_end - 1) / BKV + 1;   // up to the frontier
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  for (int i = tid; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8, pos = q0 + r / G;
    const bool ok = r < n_rows && pos < S;
    const size_t off =
        ok ? (((size_t)b * S + pos) * H + kh * G + r % G) * D + c : 0;
    attn::cp_async16(qs + r * LD + c, q + off, ok);
  }
  auto load_kv = [&](int t) {
    __nv_bfloat16* kt = ks + (t % STAGES) * BKV * LD;
    __nv_bfloat16* vt = vs + (t % STAGES) * BKV * LD;
    for (int i = tid; i < BKV * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * 8, pos = t * BKV + r;
      const bool ok = pos < S;
      const size_t off = ok ? (((size_t)b * S + pos) * K + kh) * D + c : 0;
      attn::cp_async16(kt + r * LD + c, k + off, ok);
      attn::cp_async16(vt + r * LD + c, v + off, ok);
    }
  };
  load_kv(0);
  attn::cp_async_commit();                     // group: Q and tile 0
  if (n_tiles > 1) load_kv(1);
  attn::cp_async_commit();                     // group: tile 1 (or none)

  // this thread's rows r0 (gid) and r1 (gid + 8) of the warp's 16
  const int r0 = warp * 16 + gid, r1 = r0 + 8;
  const int p0 = q0 + r0 / G, p1 = q0 + r1 / G;
  const int w_first = q0 + warp * 16 / G;
  const int w_last = min(q0 + (warp * 16 + 15) / G, q_end - 1);

  uint32_t qa[D / 16][4];
  float o[D / 8][4] = {};
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    attn::cp_async_wait<1>();                  // tile t (and Q) landed
    __syncthreads();                           // ... for every thread, and
    if (t + 2 < n_tiles) load_kv(t + 2);       // tile t - 1's stage is free
    attn::cp_async_commit();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        attn::ldmatrix_x4(qa[kk], qs + (warp * 16 + (lane & 15)) * LD +
                                      kk * 16 + (lane >> 4) * 8);
    }
    const int k0 = t * BKV;
    if (w_first <= w_last && k0 <= w_last) {
      const __nv_bfloat16* kt = ks + (t % STAGES) * BKV * LD;
      const __nv_bfloat16* vt = vs + (t % STAGES) * BKV * LD;
      float s[BKV / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int np = 0; np < BKV / 16; ++np) {
          uint32_t bk[4];
          attn::ldmatrix_x4(
              bk, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                      kk * 16 + ((lane >> 3) & 1) * 8);
          attn::mma_bf16(s[2 * np], qa[kk], bk[0], bk[1]);
          attn::mma_bf16(s[2 * np + 1], qa[kk], bk[2], bk[3]);
        }
      // scale; mask only where the tile crosses the diagonal or S
      const bool mask = k0 + BKV - 1 > w_first || k0 + BKV > S;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt * 8 + 2 * tig + (e & 1);
          const int pos = e < 2 ? p0 : p1;
          float x = s[nt][e] * scale_log2;
          if (mask && (key > pos || key >= S)) x = -INFINITY;
          s[nt][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // every row sees key 0 in tile 0, so the new maxima are finite
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt) {
        s[nt][0] = exp2f(s[nt][0] - mn0);
        s[nt][1] = exp2f(s[nt][1] - mn0);
        s[nt][2] = exp2f(s[nt][2] - mn1);
        s[nt][3] = exp2f(s[nt][3] - mn1);
        sum0 += s[nt][0] + s[nt][1];
        sum1 += s[nt][2] + s[nt][3];
      }
      l0 = l0 * a0 + sum0;                     // this lane's share
      l1 = l1 * a1 + sum1;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        o[nt][0] *= a0;
        o[nt][1] *= a0;
        o[nt][2] *= a1;
        o[nt][3] *= a1;
      }
      // O += P V: the score accumulators are P's A fragments
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint32_t pa[4] = {
            attn::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            attn::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            attn::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            attn::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bv[4];
          attn::ldmatrix_x4_trans(
              bv, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                      dp * 16 + (lane >> 4) * 8);
          attn::mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
          attn::mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
        }
      }
    }
  }
  attn::cp_async_wait<0>();                    // no copy outlives the tile

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int rows[2] = {r0, r1}, pos[2] = {p0, p1};
  const float inv[2] = {1.f / l0, 1.f / l1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= n_rows || pos[h] >= S) continue;
    __nv_bfloat16* dst =
        out + (((size_t)b * S + pos[h]) * H + kh * G + rows[h] % G) * D +
        2 * tig;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(dst + nt * 8) = attn::pack_bf16(
          o[nt][2 * h] * inv[h], o[nt][2 * h + 1] * inv[h]);
  }
}

// Block x takes q tile n_qt - 1 - x (the longest first); `paired`, it
// then takes q tile x too, so every block holds about the same number
// of kv tiles of the causal triangle.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int S, int H, int K,
                 int G, float scale_log2, int paired) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + ROWS * (D + 8);     // [STAGES][BKV][D + 8]
  __nv_bfloat16* vs = ks + STAGES * BKV * (D + 8);
  const int BQ = ROWS / G, n_qt = (S + BQ - 1) / BQ;
  const int x = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int hi = n_qt - 1 - x;
  flash_tile<D>(q, k, v, out, S, H, K, G, scale_log2, hi * BQ, kh, b, qs,
                ks, vs);
  if (paired && x < hi) {
    __syncthreads();                           // every warp done with smem
    flash_tile<D>(q, k, v, out, S, H, K, G, scale_log2, x * BQ, kh, b, qs,
                  ks, vs);
  }
}

// pair: 1 pairs q tiles, 0 does not, -1 pairs when the unpaired grid
// has more blocks than the card has SMs
template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, int B, int S, int H, int K, int pair,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = (ROWS + 2 * STAGES * BKV) * (D + 8) * 2;
  // above 48 KB of dynamic shared memory a launch needs the attribute,
  // once on each device
  static attn::DeviceOnce state;
  int n_sm = 0;
  const cudaError_t attr =
      attn::device_once(state, flash_mma_kernel<D>, smem, &n_sm);
  if (attr != cudaSuccess) return attr;
  const int G = H / K;
  if (G > ROWS) return cudaErrorInvalidValue;
  const int BQ = ROWS / G, n_qt = (S + BQ - 1) / BQ;
  if (pair < 0) pair = (long)n_qt * K * B > n_sm;
  dim3 grid(pair ? (n_qt + 1) / 2 : n_qt, K, B);
  flash_mma_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), S, H, K, G,
      scale * 1.4426950408889634f, pair);
  return cudaGetLastError();
}

// ---- fp32: CUDA cores ---------------------------------------------------

constexpr int BQ32 = 16;         // query rows per block
constexpr int BK32 = 32;         // keys per kv tile
constexpr int ROWS_PER_WARP = 4;

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 int S, int H, int K, float scale) {
  constexpr int DPL = D / 32;                 // head dims per lane
  __shared__ float qs[BQ32][D];
  __shared__ float ks[BK32][D + 1];           // +1: conflict-free columns
  __shared__ __align__(16) float vs[BK32][D];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = H / K, kh = h / G;
  const int q0 = qt * BQ32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int j = tid; j < BQ32 * D; j += THREADS) {
    const int r = j / D, c = j % D, s = q0 + r;
    qs[r][c] = s < S ? q[(((size_t)b * S + s) * H + h) * D + c] * scale
                     : 0.f;
  }

  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], o[ROWS_PER_WARP][DPL];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[r][e] = 0.f;
  }

  const int q_last = min(q0 + BQ32, S) - 1;   // causal frontier
  for (int k0 = 0; k0 <= q_last; k0 += BK32) {
    __syncthreads();                          // previous tile consumed
    for (int j = tid; j < BK32 * D; j += THREADS) {
      const int r = j / D, c = j % D, s = k0 + r;
      const size_t off = (((size_t)b * S + s) * K + kh) * D + c;
      ks[r][c] = s < S ? k[off] : 0.f;
      vs[r][c] = s < S ? v[off] : 0.f;
    }
    __syncthreads();

    // scores: lane = key of the tile, four query rows per warp
    float s[ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) s[r] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float kv = ks[lane][c];
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r)
        s[r] = fmaf(qs[warp * ROWS_PER_WARP + r][c], kv, s[r]);
    }
    const int kpos = k0 + lane;
    float p[ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int qpos = q0 + warp * ROWS_PER_WARP + r;
      const bool ok = kpos <= qpos && kpos < S;
      float sv = ok ? s[r] : NEG;
      float mt = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - m_new);
      p[r] = ok ? expf(sv - m_new) : 0.f;
      float ps = p[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[r][e] *= alpha;
    }
    // o += P V: lane owns head dims [lane*DPL, lane*DPL + DPL)
    for (int j = 0; j < BK32; ++j) {
      float vv[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) vv[e] = vs[j][lane * DPL + e];
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int e = 0; e < DPL; ++e) o[r][e] = fmaf(pj, vv[e], o[r][e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int s = q0 + warp * ROWS_PER_WARP + r;
    if (s >= S) continue;
    const float inv = 1.f / l[r];
    float* dst = out + (((size_t)b * S + s) * H + h) * D + lane * DPL;
#pragma unroll
    for (int e = 0; e < DPL; ++e) dst[e] = o[r][e] * inv;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, int B, int S, int H, int K, float scale,
                       cudaStream_t stream) {
  dim3 grid((S + BQ32 - 1) / BQ32, H, B);
  flash_f32_kernel<D><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, K,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, S, H, D), k/v (B, S, K, D), out (B, S, H, D), all contiguous in
// one dtype: bf16 when is_bf16, else fp32. D in {64, 128}, H % K == 0.
// bf16 (G = H / K at most 64): `pair` 1 pairs a long and a short q
// tile in a block, 0 does not, -1 decides by the grid's size; fp32
// ignores it.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int S,
                                   int H, int K, int D, int pair,
                                   float scale, int is_bf16, void* stream) {
  if (B < 1 || S < 1 || K < 1 || H % K || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)(D == 128 ? launch_mma<128>(q, k, v, out, B, S, H, K, pair,
                                            scale, s)
                          : launch_mma<64>(q, k, v, out, B, S, H, K, pair,
                                           scale, s));
  return (int)(D == 128
                   ? launch_f32<128>(q, k, v, out, B, S, H, K, scale, s)
                   : launch_f32<64>(q, k, v, out, B, S, H, K, scale, s));
}
