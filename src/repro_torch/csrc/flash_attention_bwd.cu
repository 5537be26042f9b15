// Causal GQA attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package differentiates its jnp
// attention (src/repro/models/attention.py:39, causal_attention) and has
// no backward kernel. This is the gradient of the forward in
// flash_attention.cu, for o = softmax(q k^T * scale, causal) v and an
// incoming dO:
//   delta = rowsum(dO * O)                     (fp32, one per row)
//   P     = exp(q k^T * scale - lse)            (lse from the forward)
//   dV    = P^T dO,  dP = dO V^T,  dS = P * (dP - delta)
//   dQ    = dS K * scale,  dK = dS^T Q * scale
// in three launches: delta; dK/dV, one block per (kv tile of 64 keys,
// kv head, batch), which loops in a fixed order over the G query heads
// of the group and the q tiles from the tile's diagonal to S; dQ, one
// block per (64 (position, head) rows, kv head, batch) as the forward's
// blocks, which loops over the kv tiles up to its causal frontier. Each
// output element is summed by one thread in a fixed order and written
// once: no atomics, so two launches on the same inputs give the same
// bits. Any S is taken (ragged tiles zero-filled and masked).
//
// What bounds it: 5 products of the forward's 2 over the S (S + 1) / 2
// causal pairs of each head (10 D operations a pair): at Qwen3-1.7B's
// train shape (B = 2, S = 4096, H = 16, K = 8, D = 128, bf16) 3.4e11
// operations, ~0.35 ms at the 989 TFLOP/s bf16 peak; its bytes (q, k, v,
// o, dO, lse in, dq, dk, dv out, ~202 MB) take ~0.060 ms at 3.35 TB/s.
// Measured on an H100 (700 W) at that shape: 2.25 ms, 6.5x the bound
// (PERF.md section 6, row 8).
// bf16 design: mma.sync m16n8k16 (bf16 in, fp32 accumulators) for every
// product, as the forward, with P and dS rounded to bf16 before their
// products; P and dS stay in registers in the accumulator layout, which
// is the A layout of the next product (dV += P^T dO and dK += dS^T Q in
// the dK/dV kernel, whose warps own 16 keys each and compute S^T = K
// Q^T directly; dQ += dS K in the dQ kernel). K/V tiles (dQ) and Q/dO
// tiles (dK/dV) come in a ring of two stages by cp.async, rows padded by
// 16 bytes for conflict-free ldmatrix. P is recomputed twice (once in
// each kernel), 7 products in all; a one-kernel design that adds dQ by
// atomics would save two but lose the fixed order. The dK/dV and dQ
// accumulators (16 x D fp32 a warp) sit in registers beside P and dP;
// the q tile of the dK/dV loop is 32 positions to keep that within one
// thread's registers. Later work for speed: wgmma on 64-row warpgroup
// tiles fed by TMA, which mma.sync cannot reach.
// fp32: exact fp32 FMAs on CUDA cores, as the forward's fp32 path: P^T
// and dS^T of a (32 keys, 8 rows) tile through shared memory in the
// dK/dV kernel, dS broadcast by shuffles in the dQ kernel.
#include "attn_mma.cuh"

namespace {

constexpr int THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---- delta = rowsum(dO * O), a warp a (b, s, h) row ----------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int S, int H, int D, long rows) {
  const long row = (long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* po = o + row * D;
  const T* pd = dout + row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(to_f(pd[c]), to_f(po[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long bs = row / H;
    delta[(bs / S * H + row % H) * S + bs % S] = acc;
  }
}

// ---- bf16: tensor cores ---------------------------------------------------

constexpr int BKV = 64;          // keys per kv tile (16 a warp in dK/dV)
constexpr int BQB = 32;          // positions per q tile of the dK/dV loop
constexpr int ROWS = 64;         // (position, head) rows of a dQ block

// One block: keys k0 .. k0 + 63 of kv head kh, sequence b. Every thread
// holds two keys (key0, key1 = key0 + 8) of its warp's 16, and their
// dK and dV rows (its D / 4 columns of each) in registers.
template <int D>
__global__ void __launch_bounds__(THREADS)
dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, int S, int H, int K, int G,
                float scale) {
  constexpr int LD = D + 8;                    // padded row, elements
  constexpr int CPR = D / 8;                   // 16-byte copies per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + BKV * LD;
  __nv_bfloat16* qs = vs + BKV * LD;           // [2][BQB][LD]
  __nv_bfloat16* gs = qs + 2 * BQB * LD;       // [2][BQB][LD], dO
  float* ls = reinterpret_cast<float*>(gs + 2 * BQB * LD);  // [2][BQB]
  float* dl = ls + 2 * BQB;                                  // [2][BQB]

  const int k0 = blockIdx.x * BKV, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int qt0 = k0 / BQB, nq = (S + BQB - 1) / BQB - qt0;
  const int n_iter = G * nq;                   // (head, q tile) steps
  const float scale_log2 = scale * LOG2E;

  for (int i = tid; i < BKV * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8, pos = k0 + r;
    const bool ok = pos < S;
    const size_t off = ok ? (((size_t)b * S + pos) * K + kh) * D + c : 0;
    attn::cp_async16(ks + r * LD + c, k + off, ok);
    attn::cp_async16(vs + r * LD + c, v + off, ok);
  }
  // step it: head kh * G + it / nq, q tile qt0 + it % nq, into stage it & 1
  auto load_q = [&](int it) {
    const int st = it & 1, h = kh * G + it / nq;
    const int q0 = (qt0 + it % nq) * BQB;
    __nv_bfloat16* qt = qs + st * BQB * LD;
    __nv_bfloat16* gt = gs + st * BQB * LD;
    for (int i = tid; i < BQB * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * 8, pos = q0 + r;
      const bool ok = pos < S;
      const size_t off = ok ? (((size_t)b * S + pos) * H + h) * D + c : 0;
      attn::cp_async16(qt + r * LD + c, q + off, ok);
      attn::cp_async16(gt + r * LD + c, dout + off, ok);
    }
    for (int r = tid; r < BQB; r += THREADS) {
      const int pos = q0 + r;
      const size_t off = ((size_t)b * H + h) * S + pos;
      ls[st * BQB + r] = pos < S ? lse[off] * LOG2E : 0.f;
      dl[st * BQB + r] = pos < S ? delta[off] : 0.f;
    }
  };
  load_q(0);
  attn::cp_async_commit();                     // group: K, V and step 0

  const int kw0 = k0 + warp * 16;              // the warp's first key
  const int key0 = kw0 + gid, key1 = key0 + 8;
  float dka[D / 8][4] = {}, dva[D / 8][4] = {};
  for (int it = 0; it < n_iter; ++it) {
    attn::cp_async_wait<0>();                  // step it landed
    __syncthreads();                           // ... for all; and stage
    if (it + 1 < n_iter) load_q(it + 1);       // (it + 1) & 1 is free
    attn::cp_async_commit();
    const int st = it & 1, q0 = (qt0 + it % nq) * BQB;
    // no position of the tile sees the warp's keys, or none is < S
    if (kw0 >= S || q0 + BQB - 1 < kw0) continue;
    const __nv_bfloat16* qt = qs + st * BQB * LD;
    const __nv_bfloat16* gt = gs + st * BQB * LD;
    const float* lt = ls + st * BQB;
    const float* dlt = dl + st * BQB;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQB positions a warp
    float s[BQB / 8][4] = {}, dp[BQB / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      const int aoff = (warp * 16 + (lane & 15)) * LD + kk * 16 +
                       (lane >> 4) * 8;
      attn::ldmatrix_x4(ka, ks + aoff);
      attn::ldmatrix_x4(va, vs + aoff);
#pragma unroll
      for (int np = 0; np < BQB / 16; ++np) {
        uint32_t bq[4], bg[4];
        const int boff = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                         kk * 16 + ((lane >> 3) & 1) * 8;
        attn::ldmatrix_x4(bq, qt + boff);
        attn::ldmatrix_x4(bg, gt + boff);
        attn::mma_bf16(s[2 * np], ka, bq[0], bq[1]);
        attn::mma_bf16(s[2 * np + 1], ka, bq[2], bq[3]);
        attn::mma_bf16(dp[2 * np], va, bg[0], bg[1]);
        attn::mma_bf16(dp[2 * np + 1], va, bg[2], bg[3]);
      }
    }
    // P^T and dS^T in place; column c is position q0 + c. Mask only
    // where the tile crosses the warp's diagonal or the end of S.
    const bool mask = q0 < kw0 + 15 || q0 + BQB > S;
#pragma unroll
    for (int nt = 0; nt < BQB / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * tig + (e & 1), pos = q0 + c;
        const int key = e < 2 ? key0 : key1;
        float p = exp2f(s[nt][e] * scale_log2 - lt[c]);
        if (mask && (key > pos || pos >= S)) p = 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - dlt[c]);
      }
    // dV += P^T dO, dK += dS^T Q: P^T and dS^T are the A fragments
#pragma unroll
    for (int kc = 0; kc < BQB / 16; ++kc) {
      const uint32_t pa[4] = {
          attn::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
          attn::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          attn::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          attn::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const uint32_t da[4] = {
          attn::pack_bf16(dp[2 * kc][0], dp[2 * kc][1]),
          attn::pack_bf16(dp[2 * kc][2], dp[2 * kc][3]),
          attn::pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]),
          attn::pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3])};
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t bg[4], bq[4];
        const int boff = (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             LD + dd * 16 + (lane >> 4) * 8;
        attn::ldmatrix_x4_trans(bg, gt + boff);
        attn::ldmatrix_x4_trans(bq, qt + boff);
        attn::mma_bf16(dva[2 * dd], pa, bg[0], bg[1]);
        attn::mma_bf16(dva[2 * dd + 1], pa, bg[2], bg[3]);
        attn::mma_bf16(dka[2 * dd], da, bq[0], bq[1]);
        attn::mma_bf16(dka[2 * dd + 1], da, bq[2], bq[3]);
      }
    }
  }
  attn::cp_async_wait<0>();                    // no copy outlives the block

  const int keys[2] = {key0, key1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (keys[h] >= S) continue;
    const size_t off = (((size_t)b * S + keys[h]) * K + kh) * D + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(dk + off + nt * 8) = attn::pack_bf16(
          dka[nt][2 * h] * scale, dka[nt][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + nt * 8) =
          attn::pack_bf16(dva[nt][2 * h], dva[nt][2 * h + 1]);
    }
  }
}

// One block: q tile n_qt - 1 - blockIdx.x (the longest first) of 64 / G
// positions x the G heads of kv head kh as its 64 rows (row = position
// * G + head, as the forward), sequence b; 16 rows a warp.
template <int D>
__global__ void __launch_bounds__(THREADS)
dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, int S, int H, int K, int G,
              float scale) {
  constexpr int LD = D + 8;
  constexpr int CPR = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* gs = qs + ROWS * LD;          // dO rows
  __nv_bfloat16* ks = gs + ROWS * LD;          // [2][BKV][LD]
  __nv_bfloat16* vs = ks + 2 * BKV * LD;       // [2][BKV][LD]

  const int BQ = ROWS / G, n_rows = BQ * G;
  const int n_qt = (S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - blockIdx.x) * BQ, kh = blockIdx.y;
  const int b = blockIdx.z;
  const int q_end = min(q0 + BQ, S);
  const int n_tiles = (q_end - 1) / BKV + 1;   // up to the frontier
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const float scale_log2 = scale * LOG2E;

  for (int i = tid; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8, pos = q0 + r / G;
    const bool ok = r < n_rows && pos < S;
    const size_t off =
        ok ? (((size_t)b * S + pos) * H + kh * G + r % G) * D + c : 0;
    attn::cp_async16(qs + r * LD + c, q + off, ok);
    attn::cp_async16(gs + r * LD + c, dout + off, ok);
  }
  auto load_kv = [&](int t) {
    __nv_bfloat16* kt = ks + (t & 1) * BKV * LD;
    __nv_bfloat16* vt = vs + (t & 1) * BKV * LD;
    for (int i = tid; i < BKV * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * 8, pos = t * BKV + r;
      const bool ok = pos < S;
      const size_t off = ok ? (((size_t)b * S + pos) * K + kh) * D + c : 0;
      attn::cp_async16(kt + r * LD + c, k + off, ok);
      attn::cp_async16(vt + r * LD + c, v + off, ok);
    }
  };
  load_kv(0);
  attn::cp_async_commit();                     // group: Q, dO and tile 0

  // this thread's rows r0 (gid) and r1 (gid + 8) of the warp's 16
  const int r0 = warp * 16 + gid, r1 = r0 + 8;
  const int p0 = q0 + r0 / G, p1 = q0 + r1 / G;
  const bool ok0 = r0 < n_rows && p0 < S, ok1 = r1 < n_rows && p1 < S;
  const size_t st0 = ((size_t)b * H + kh * G + r0 % G) * S + p0;
  const size_t st1 = ((size_t)b * H + kh * G + r1 % G) * S + p1;
  const float l0 = ok0 ? lse[st0] * LOG2E : 0.f;
  const float l1 = ok1 ? lse[st1] * LOG2E : 0.f;
  const float d0 = ok0 ? delta[st0] : 0.f, d1 = ok1 ? delta[st1] : 0.f;
  const int w_first = q0 + warp * 16 / G;
  const int w_last = min(q0 + (warp * 16 + 15) / G, q_end - 1);

  float dqa[D / 8][4] = {};
  for (int t = 0; t < n_tiles; ++t) {
    attn::cp_async_wait<0>();                  // tile t landed
    __syncthreads();                           // ... for all; and stage
    if (t + 1 < n_tiles) load_kv(t + 1);       // (t + 1) & 1 is free
    attn::cp_async_commit();
    const int k0 = t * BKV;
    if (w_first > w_last || k0 > w_last) continue;
    const __nv_bfloat16* kt = ks + (t & 1) * BKV * LD;
    const __nv_bfloat16* vt = vs + (t & 1) * BKV * LD;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys a warp
    float s[BKV / 8][4] = {}, dp[BKV / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], ga[4];
      const int aoff = (warp * 16 + (lane & 15)) * LD + kk * 16 +
                       (lane >> 4) * 8;
      attn::ldmatrix_x4(qa, qs + aoff);
      attn::ldmatrix_x4(ga, gs + aoff);
#pragma unroll
      for (int np = 0; np < BKV / 16; ++np) {
        uint32_t bk[4], bv[4];
        const int boff = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                         kk * 16 + ((lane >> 3) & 1) * 8;
        attn::ldmatrix_x4(bk, kt + boff);
        attn::ldmatrix_x4(bv, vt + boff);
        attn::mma_bf16(s[2 * np], qa, bk[0], bk[1]);
        attn::mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
        attn::mma_bf16(dp[2 * np], ga, bv[0], bv[1]);
        attn::mma_bf16(dp[2 * np + 1], ga, bv[2], bv[3]);
      }
    }
    // dS = P * (dP - delta) in place of S
    const bool mask = k0 + BKV - 1 > w_first || k0 + BKV > S;
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * tig + (e & 1);
        const int pos = e < 2 ? p0 : p1;
        float p = exp2f(s[nt][e] * scale_log2 - (e < 2 ? l0 : l1));
        if (mask && (key > pos || key >= S)) p = 0.f;
        s[nt][e] = p * (dp[nt][e] - (e < 2 ? d0 : d1));
      }
    // dQ += dS K: dS is the A fragment, K the B operand transposed
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      const uint32_t da[4] = {
          attn::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
          attn::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          attn::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          attn::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t bk[4];
        attn::ldmatrix_x4_trans(
            bk, kt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                    dd * 16 + (lane >> 4) * 8);
        attn::mma_bf16(dqa[2 * dd], da, bk[0], bk[1]);
        attn::mma_bf16(dqa[2 * dd + 1], da, bk[2], bk[3]);
      }
    }
  }
  attn::cp_async_wait<0>();

  const int rows[2] = {r0, r1}, pos[2] = {p0, p1};
  const bool ok[2] = {ok0, ok1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!ok[h]) continue;
    __nv_bfloat16* dst =
        dq + (((size_t)b * S + pos[h]) * H + kh * G + rows[h] % G) * D +
        2 * tig;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(dst + nt * 8) = attn::pack_bf16(
          dqa[nt][2 * h] * scale, dqa[nt][2 * h + 1] * scale);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dq, void* dk, void* dv,
                       int B, int S, int H, int K, float scale,
                       cudaStream_t stream) {
  constexpr int LD = D + 8;
  constexpr size_t smem_kv =
      (2 * BKV + 4 * BQB) * LD * 2 + 4 * BQB * sizeof(float);
  constexpr size_t smem_q = (2 * ROWS + 4 * BKV) * LD * 2;
  static attn::DeviceOnce st_kv, st_q;
  int n_sm = 0;
  cudaError_t err =
      attn::device_once(st_kv, dkdv_mma_kernel<D>, smem_kv, &n_sm);
  if (err != cudaSuccess) return err;
  err = attn::device_once(st_q, dq_mma_kernel<D>, smem_q, &n_sm);
  if (err != cudaSuccess) return err;
  const int G = H / K;
  if (G > ROWS) return cudaErrorInvalidValue;
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* gb = static_cast<const __nv_bfloat16*>(dout);
  dkdv_mma_kernel<D><<<dim3((S + BKV - 1) / BKV, K, B), THREADS, smem_kv,
                       stream>>>(qb, kb, vb, gb, lse, delta,
                                 static_cast<__nv_bfloat16*>(dk),
                                 static_cast<__nv_bfloat16*>(dv), S, H, K,
                                 G, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int BQ = ROWS / G;
  dq_mma_kernel<D><<<dim3((S + BQ - 1) / BQ, K, B), THREADS, smem_q,
                     stream>>>(qb, kb, vb, gb, lse, delta,
                               static_cast<__nv_bfloat16*>(dq), S, H, K, G,
                               scale);
  return cudaGetLastError();
}

// ---- fp32: CUDA cores -----------------------------------------------------

constexpr int BK32 = 32;         // keys per kv tile
constexpr int BQ32 = 8;          // query rows per q tile (two a warp:
constexpr int ROWS_PER_WARP = 2; // the padded K/V tiles fill the 48 KB)

// One block: keys k0 .. k0 + 31 of kv head kh, sequence b, over the G
// heads and the 8-position q tiles from the diagonal. Scores: lane =
// key, two rows a warp (as the forward); then thread t accumulates key
// t / 4's dK and dV at columns t % 4, t % 4 + 4, ...
template <int D>
__global__ void __launch_bounds__(THREADS)
dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int S, int H, int K, float scale) {
  constexpr int CPT = D / 4;                  // columns a thread
  __shared__ float ks[BK32][D + 1];           // +1: conflict-free columns
  __shared__ float vs[BK32][D + 1];
  __shared__ float qs[BQ32][D];               // q * scale
  __shared__ float gs[BQ32][D];               // dO
  __shared__ float pt[BK32][BQ32 + 1];        // P^T
  __shared__ float dst[BK32][BQ32 + 1];       // dS^T
  __shared__ float ls[BQ32], dl[BQ32];

  const int k0 = blockIdx.x * BK32, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int key = tid >> 2, part = tid & 3;   // accumulation layout

  for (int j = tid; j < BK32 * D; j += THREADS) {
    const int r = j / D, c = j % D, s = k0 + r;
    const size_t off = (((size_t)b * S + s) * K + kh) * D + c;
    ks[r][c] = s < S ? k[off] : 0.f;
    vs[r][c] = s < S ? v[off] : 0.f;
  }
  float ak[CPT], av[CPT];
#pragma unroll
  for (int e = 0; e < CPT; ++e) ak[e] = av[e] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int q0 = k0 / BQ32 * BQ32; q0 < S; q0 += BQ32) {
      __syncthreads();                        // previous tile consumed
      for (int j = tid; j < BQ32 * D; j += THREADS) {
        const int r = j / D, c = j % D, s = q0 + r;
        const size_t off = (((size_t)b * S + s) * H + h) * D + c;
        qs[r][c] = s < S ? q[off] * scale : 0.f;
        gs[r][c] = s < S ? dout[off] : 0.f;
      }
      if (tid < BQ32) {
        const int s = q0 + tid;
        const size_t off = ((size_t)b * H + h) * S + s;
        ls[tid] = s < S ? lse[off] : 0.f;
        dl[tid] = s < S ? delta[off] : 0.f;
      }
      __syncthreads();
      float sc[ROWS_PER_WARP], dp[ROWS_PER_WARP];
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) sc[r] = dp[r] = 0.f;
      for (int c = 0; c < D; ++c) {
        const float kc = ks[lane][c], vc = vs[lane][c];
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) {
          sc[r] = fmaf(qs[warp * ROWS_PER_WARP + r][c], kc, sc[r]);
          dp[r] = fmaf(gs[warp * ROWS_PER_WARP + r][c], vc, dp[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const int row = warp * ROWS_PER_WARP + r, pos = q0 + row;
        const bool ok = k0 + lane <= pos && pos < S;
        const float p = ok ? expf(sc[r] - ls[row]) : 0.f;
        pt[lane][row] = p;
        dst[lane][row] = p * (dp[r] - dl[row]);
      }
      __syncthreads();
      for (int r = 0; r < BQ32; ++r) {
        const float p = pt[key][r], ds = dst[key][r];
#pragma unroll
        for (int e = 0; e < CPT; ++e) {
          av[e] = fmaf(p, gs[r][e * 4 + part], av[e]);
          ak[e] = fmaf(ds, qs[r][e * 4 + part], ak[e]);
        }
      }
    }
  }
  const int s = k0 + key;
  if (s < S) {
    const size_t off = (((size_t)b * S + s) * K + kh) * D + part;
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      dk[off + e * 4] = ak[e];
      dv[off + e * 4] = av[e];
    }
  }
}

// One block: 8 rows (positions) of q head h, sequence b, over the kv
// tiles up to its frontier: lane = key for the scores, two rows a
// warp; dQ += dS K with lane owning D / 32 columns (dS by shuffles).
template <int D>
__global__ void __launch_bounds__(THREADS)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int S, int H, int K, float scale) {
  constexpr int DPL = D / 32;                 // columns a lane
  __shared__ float qs[BQ32][D];               // q * scale
  __shared__ float gs[BQ32][D];               // dO
  __shared__ float ks[BK32][D + 1];
  __shared__ float vs[BK32][D + 1];

  const int q0 = blockIdx.x * BQ32, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int j = tid; j < BQ32 * D; j += THREADS) {
    const int r = j / D, c = j % D, s = q0 + r;
    const size_t off = (((size_t)b * S + s) * H + h) * D + c;
    qs[r][c] = s < S ? q[off] * scale : 0.f;
    gs[r][c] = s < S ? dout[off] : 0.f;
  }
  float lr[ROWS_PER_WARP], dr[ROWS_PER_WARP], acc[ROWS_PER_WARP][DPL];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int s = q0 + warp * ROWS_PER_WARP + r;
    const size_t off = ((size_t)b * H + h) * S + s;
    lr[r] = s < S ? lse[off] : 0.f;
    dr[r] = s < S ? delta[off] : 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
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
    float sc[ROWS_PER_WARP], dp[ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) sc[r] = dp[r] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float kc = ks[lane][c], vc = vs[lane][c];
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        sc[r] = fmaf(qs[warp * ROWS_PER_WARP + r][c], kc, sc[r]);
        dp[r] = fmaf(gs[warp * ROWS_PER_WARP + r][c], vc, dp[r]);
      }
    }
    float ds[ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int pos = q0 + warp * ROWS_PER_WARP + r, kpos = k0 + lane;
      const bool ok = kpos <= pos && kpos < S && pos < S;
      ds[r] = ok ? expf(sc[r] - lr[r]) * (dp[r] - dr[r]) : 0.f;
    }
    for (int j = 0; j < BK32; ++j) {
      float kv[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) kv[e] = ks[j][lane * DPL + e];
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const float dj = __shfl_sync(0xffffffffu, ds[r], j);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(dj, kv[e], acc[r][e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int s = q0 + warp * ROWS_PER_WARP + r;
    if (s >= S) continue;
    float* out = dq + (((size_t)b * S + s) * H + h) * D + lane * DPL;
#pragma unroll
    for (int e = 0; e < DPL; ++e) out[e] = acc[r][e] * scale;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dq, void* dk, void* dv,
                       int B, int S, int H, int K, float scale,
                       cudaStream_t stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* gf = static_cast<const float*>(dout);
  dkdv_f32_kernel<D><<<dim3((S + BK32 - 1) / BK32, K, B), THREADS, 0,
                       stream>>>(qf, kf, vf, gf, lse, delta,
                                 static_cast<float*>(dk),
                                 static_cast<float*>(dv), S, H, K, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_f32_kernel<D><<<dim3((S + BQ32 - 1) / BQ32, H, B), THREADS, 0,
                     stream>>>(qf, kf, vf, gf, lse, delta,
                               static_cast<float*>(dq), S, H, K, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq (B, S, H, D); k, v, dk, dv (B, S, K, D); all contiguous
// in one dtype: bf16 when is_bf16, else fp32. lse (B, H, S) fp32 from
// flash_attention_fwd on the same q, k, v; delta (B, H, S) fp32
// workspace. D in {64, 128}, H % K == 0, and for bf16 G = H / K at most
// 64. dq, dk and dv are written whole, each element once.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const float* lse, const void* dout,
                                   void* dq, void* dk, void* dv,
                                   float* delta, int B, int S, int H, int K,
                                   int D, float scale, int is_bf16,
                                   void* stream) {
  if (B < 1 || S < 1 || K < 1 || H % K || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const long rows = (long)B * S * H;
  const dim3 grid((unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)));
  if (is_bf16)
    delta_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), delta, S, H, D, rows);
  else
    delta_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout),
        delta, S, H, D, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (is_bf16)
    return (int)(D == 128 ? launch_mma<128>(q, k, v, dout, lse, delta, dq,
                                            dk, dv, B, S, H, K, scale, s)
                          : launch_mma<64>(q, k, v, dout, lse, delta, dq,
                                           dk, dv, B, S, H, K, scale, s));
  return (int)(D == 128 ? launch_f32<128>(q, k, v, dout, lse, delta, dq, dk,
                                          dv, B, S, H, K, scale, s)
                        : launch_f32<64>(q, k, v, dout, lse, delta, dq, dk,
                                         dv, B, S, H, K, scale, s));
}
