// GQA decode attention for Hopper (sm_90a), plain C interface:
// split-KV ("flash-decoding") with staged tiles and tensor cores.
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention/kernel.py:decode_attention
// (pallas_call at :95): one new token per sequence attends over its KV
// cache, positions at or past lengths[b] are masked, and the G query
// heads that share a kv head are carried together.
//
// What bounds it: bytes. A call reads the live part of the cache,
// 2 * sum_b lengths[b] * K * D elements, once, and does ~4*G flops per
// element read, far below the ~295 flop/byte at which the H100's bf16
// tensor cores, not its 3.35 TB/s, would be the limit. At the serving
// shapes (B <= 8, K = 8, a few hundred live keys) the bytes take a few
// microseconds, so latency (launch, one round trip to HBM, the merge)
// is what a call costs.
// Design: the TPU grid walked the sequence tiles of one (batch, kv
// head) in order, carrying the softmax state. Here one block owns one
// chunk of keys of one (batch, kv head): grid (ceil(S / chunk), K, B),
// sized from S on the host, which never reads `lengths`; a block whose
// chunk starts at or past lengths[b] exits at once. A chunk is 128
// keys, 8 warps (chunks of 32 and 64 keys measured slower on the H100
// at the serving shapes: more blocks that exit at once, more partials
// to merge): at B = 8, K = 8, S = 512 that is 256 blocks for 132 SMs,
// of which the live ones hold the cache. Each warp owns
// 16 keys of the chunk and stages them with cp.async, 16 bytes a lane,
// neighbour lanes on neighbour addresses; the K rows and the V rows are
// two copy groups, so the V copy is in flight while K is scored. bf16: q K^T
// and P V run on the tensor cores (mma.sync m16n8k16, fp32
// accumulators), the G heads as the A rows padded to 16, K and V
// fragments by ldmatrix from rows padded against bank conflicts. fp32:
// exact fp32 FMAs on CUDA cores behind the same grid and staging.
// The warps' (m, l, o) states merge in shared memory into the chunk's
// partial. A sequence with one live chunk writes its output directly;
// otherwise each chunk writes its fp32 partial to a scratch tensor and
// takes a ticket, and the last block of the (batch, kv head) to arrive
// resets the ticket and merges all partials in split order, so the
// output does not depend on the arrival order. One launch per call.
// Length 0 gives a zero output.
// GQA groups: a block carries GT of the G query heads that share its kv
// head, with GT the smallest of 1, 2, 4, 8, 16 (bf16; up to 8 for fp32)
// that holds G, so the groups 1-16 of the dense configs take one block
// per (chunk, kv head). A larger G (Llama-4-Scout's 5 is 8 rows; G = 40
// or 64 is 3 or 4 blocks of 16) splits into ceil(G / GT) head tiles,
// each its own block over the same keys, with its own partials and
// ticket. bf16 carries the GT heads as the rows of the m16 mma: rows
// gid and gid + 8 of the A fragment, so GT = 16 fills them exactly.
#include "attn_mma.cuh"

namespace {

constexpr int KEYS_PER_WARP = 16;
constexpr int WARPS = 8;
constexpr int CHUNK = WARPS * KEYS_PER_WARP;   // keys per block

// elements per staged row: D and 16 bytes of padding
template <typename T, int D>
__host__ __device__ constexpr int smem_ld() {
  return D + 16 / (int)sizeof(T);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Scores of the warp's keys for the block's gn <= GT heads, softmax over
// them, and P V. On return this warp's m[g], l[g] (log2 units) are in
// red_m/red_l and o[g][:] (unnormalised) in `wo` (fp32, gn x D), which
// overwrites the warp's staged K and V rows.
template <int D, int GT>
__device__ __forceinline__ void warp_tile(
    const __nv_bfloat16* qh, const __nv_bfloat16* kw,
    const __nv_bfloat16* vw, int nk, float scale_log2, float* wo,
    float* red_m, float* red_l, const float*, int gn) {
  constexpr int LD = smem_ld<__nv_bfloat16, D>();
  constexpr bool TWO = GT > 8;             // A rows gid + 8 carry heads
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  // A fragments of q: rows gid and gid + 8 are heads gid and gid + 8
  // (heads >= gn are zero padding)
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(
        qh + gid * D + kk * 16 + 2 * tig);
    qa[kk][0] = gid < gn ? q0[0] : 0u;
    qa[kk][2] = gid < gn ? q0[4] : 0u;     // 8 columns further
    qa[kk][1] = qa[kk][3] = 0u;
    if constexpr (TWO) {
      const uint32_t* q1 = reinterpret_cast<const uint32_t*>(
          qh + (gid + 8) * D + kk * 16 + 2 * tig);
      qa[kk][1] = gid + 8 < gn ? q1[0] : 0u;
      qa[kk][3] = gid + 8 < gn ? q1[4] : 0u;
    }
  }
  attn::cp_async_wait<1>();                // this lane's K copies landed
  __syncwarp();                            // ... and every lane's
  float s[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t (&a)[4] = qa[kk];
    uint32_t bk[4];
    attn::ldmatrix_x4(bk, kw + ((lane & 7) + ((lane >> 4) << 3)) * LD +
                              kk * 16 + ((lane >> 3) & 1) * 8);
    attn::mma_bf16(s[0], a, bk[0], bk[1]);
    attn::mma_bf16(s[1], a, bk[2], bk[3]);
  }
  // lane holds head gid's scores (e = 0, 1) and head gid + 8's (e = 2,
  // 3) for keys 8nt + 2tig + (e & 1)
  constexpr int NE = TWO ? 4 : 2;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int key = nt * 8 + 2 * tig + (e & 1);
      s[nt][e] = key < nk ? s[nt][e] * scale_log2 : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < NE / 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      s[nt][e] = exp2f(s[nt][e] - mx[e >> 1]);   // masked: exp2(-inf) = 0
      l[e >> 1] += s[nt][e];
    }
#pragma unroll
  for (int h = 0; h < NE / 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const uint32_t pa[4] = {
      attn::pack_bf16(s[0][0], s[0][1]),
      TWO ? attn::pack_bf16(s[0][2], s[0][3]) : 0u,
      attn::pack_bf16(s[1][0], s[1][1]),
      TWO ? attn::pack_bf16(s[1][2], s[1][3]) : 0u};
  attn::cp_async_wait<0>();                // V landed
  __syncwarp();
  float o[D / 8][4] = {};
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    uint32_t bv[4];
    attn::ldmatrix_x4_trans(
        bv, vw + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                (lane >> 4) * 8);
    attn::mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
    attn::mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
  }
  __syncwarp();                            // every lane done with K, V
#pragma unroll
  for (int h = 0; h < NE / 2; ++h) {
    const int g = gid + 8 * h;
    if (g < gn) {
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<float2*>(wo + g * D + nt * 8 + 2 * tig) =
            make_float2(o[nt][2 * h], o[nt][2 * h + 1]);
      if (tig == 0) {
        red_m[g] = mx[h];
        red_l[g] = l[h];
      }
    }
  }
}

template <int D, int G>
__device__ __forceinline__ void warp_tile(
    const float*, const float* kw, const float* vw, int nk,
    float scale_log2, float* wo, float* red_m, float* red_l,
    const float* qs, int gn) {
  constexpr int LD = smem_ld<float, D>();
  constexpr int HALF = D / 2, DPL = D / 32;
  const int lane = threadIdx.x & 31, key = lane & 15, half = lane >> 4;
  attn::cp_async_wait<1>();
  __syncwarp();
  // lanes key and key + 16 split the key's dot products in two halves
  float s[G];
#pragma unroll
  for (int g = 0; g < G; ++g) s[g] = 0.f;
  const float* kr = kw + key * LD + half * HALF;
#pragma unroll 4
  for (int c = 0; c < HALF; c += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 qv =
          *reinterpret_cast<const float4*>(qs + g * D + half * HALF + c);
      s[g] = fmaf(qv.x, kv.x, s[g]);
      s[g] = fmaf(qv.y, kv.y, s[g]);
      s[g] = fmaf(qv.z, kv.z, s[g]);
      s[g] = fmaf(qv.w, kv.w, s[g]);
    }
  }
  float p[G], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    s[g] += __shfl_xor_sync(0xffffffffu, s[g], 16);
    const float sv = key < nk ? s[g] * scale_log2 : -INFINITY;
    m[g] = sv;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      m[g] = fmaxf(m[g], __shfl_xor_sync(0xffffffffu, m[g], off));
    p[g] = exp2f(sv - m[g]);
    l[g] = p[g];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
  }
  attn::cp_async_wait<0>();
  __syncwarp();
  float o[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[g][e] = 0.f;
  for (int j = 0; j < nk; ++j) {
    float vv[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) vv[e] = vw[j * LD + lane * DPL + e];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float pj = __shfl_sync(0xffffffffu, p[g], j);
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[g][e] = fmaf(pj, vv[e], o[g][e]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g >= gn) break;                    // padding heads: q rows zero
#pragma unroll
    for (int e = 0; e < DPL; ++e) wo[g * D + lane * DPL + e] = o[g][e];
    if (lane == 0) {
      red_m[g] = m[g];
      red_l[g] = l[g];
    }
  }
}

template <typename T, int D, int GT>
__global__ void __launch_bounds__(WARPS * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ lengths,
              T* __restrict__ out, float* part, int* tickets, int S,
              int K, int G, float scale_log2) {
  constexpr int LD = smem_ld<T, D>();
  constexpr int VEC = 16 / (int)sizeof(T);     // elements per copy
  constexpr int CPR = D / VEC;                 // copies per row
  constexpr int NT = WARPS * 32;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int P = GT * (D + 2);              // floats per partial
  constexpr int WR = 2 * KEYS_PER_WARP * LD;   // a warp's K and V rows
  // each warp's K then V rows; after P V its fp32 (GT, D) output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  static_assert(GT * D * 4 <= WR * (int)sizeof(T), "output overflows");
  __shared__ __align__(16) float qs[F32 ? GT : 1][D];
  __shared__ float red_m[WARPS][GT], red_l[WARPS][GT];
  __shared__ int last;

  // blockIdx.y = kv head x head tile: heads g0 .. g0 + gn - 1 of the
  // kv head's G
  const int n_ht = (G + GT - 1) / GT;
  const int c = blockIdx.x, y = blockIdx.y, b = blockIdx.z;
  const int kh = y / n_ht, g0 = (y % n_ht) * GT, gn = min(GT, G - g0);
  const int H = K * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(lengths[b], 0), S);
  const int n_live = (len + CHUNK - 1) / CHUNK;
  const int n_split = gridDim.x;
  const size_t slot = (size_t)b * gridDim.y + y;   // partials, ticket
  T* outp = out + ((size_t)b * H + kh * G + g0) * D;
  if (len == 0) {                              // no key: zero output
    if (c == 0)
      for (int j = tid; j < gn * D; j += NT) store(outp + j, 0.f);
    return;
  }
  if (c >= n_live) return;

  const T* qh = q + ((size_t)b * H + kh * G + g0) * D;
  const int k0 = c * CHUNK + warp * KEYS_PER_WARP;
  const int nk = min(KEYS_PER_WARP, len - k0);  // this warp's keys
  T* kw = reinterpret_cast<T*>(smem_raw) + warp * WR;
  T* vw = kw + KEYS_PER_WARP * LD;
  float* wo = reinterpret_cast<float*>(kw);
  if (nk > 0) {
    const size_t rs = (size_t)K * D;           // between positions
    const T* kb = kc + ((size_t)b * S * K + kh) * D;
    const T* vb = vc + ((size_t)b * S * K + kh) * D;
    for (int i = lane; i < KEYS_PER_WARP * CPR; i += 32) {
      const int r = i / CPR, cc = (i % CPR) * VEC;
      const bool ok = r < nk;                  // past len: zero rows
      attn::cp_async16(kw + r * LD + cc, kb + (ok ? (k0 + r) * rs : 0) + cc,
                       ok);
    }
    attn::cp_async_commit();
    for (int i = lane; i < KEYS_PER_WARP * CPR; i += 32) {
      const int r = i / CPR, cc = (i % CPR) * VEC;
      const bool ok = r < nk;
      attn::cp_async16(vw + r * LD + cc, vb + (ok ? (k0 + r) * rs : 0) + cc,
                       ok);
    }
    attn::cp_async_commit();
  }
  if constexpr (F32) {
    for (int j = tid; j < GT * D; j += NT)
      qs[j / D][j % D] = j < gn * D ? static_cast<float>(qh[j]) : 0.f;
    __syncthreads();
  }
  if (nk > 0) {
    warp_tile<D, GT>(qh, kw, vw, nk, scale_log2, wo, red_m[warp],
                     red_l[warp], &qs[0][0], gn);
  } else if (lane < GT) {
    red_m[warp][lane] = -INFINITY;
    red_l[warp][lane] = 0.f;
  }
  __syncthreads();

  // merge the warps into the chunk's state
  float* pc = part + (slot * n_split + c) * P;
  for (int j = tid; j < gn * D; j += NT) {
    const int g = j / D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (red_l[w][g] > 0.f) mx = fmaxf(mx, red_m[w][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (red_l[w][g] > 0.f) {
        const float f = exp2f(red_m[w][g] - mx);
        L += red_l[w][g] * f;
        O += reinterpret_cast<const float*>(
                 reinterpret_cast<T*>(smem_raw) + w * WR)[j] * f;
      }
    if (n_live == 1) {
      store(outp + j, O / L);
    } else {
      pc[j] = O;
      if (j % D == 0) {
        pc[GT * D + g] = mx;
        pc[GT * D + GT + g] = L;
      }
    }
  }
  if (n_live == 1) return;

  // the last chunk of (b, kv head, head tile) to finish merges all of
  // them, in order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int t = atomicAdd(tickets + slot, 1);
    last = t == n_live - 1;
    if (last) tickets[slot] = 0;               // ready for the next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* pb = part + slot * n_split * P;
  for (int j = tid; j < gn * D; j += NT) {
    const int g = j / D;
    float M = -INFINITY, L = 0.f, O = 0.f;     // one pass, split order
#pragma unroll 4
    for (int s = 0; s < n_live; ++s) {
      const float ms = __ldcg(pb + s * P + GT * D + g);
      const float ls = __ldcg(pb + s * P + GT * D + GT + g);
      const float os = __ldcg(pb + s * P + j);
      const float mn = fmaxf(M, ms);
      const float a = exp2f(M - mn), f = exp2f(ms - mn);
      L = L * a + ls * f;
      O = O * a + os * f;
      M = mn;
    }
    store(outp + j, O / L);
  }
}

template <typename T, int D, int GT>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const int* lengths, void* out, float* part,
                   int* tickets, int B, int S, int K, int G,
                   float scale_log2, cudaStream_t stream) {
  constexpr size_t smem = 2 * CHUNK * smem_ld<T, D>() * sizeof(T);
  // above 48 KB of dynamic shared memory a launch needs the attribute,
  // once on each device
  static attn::DeviceOnce state;
  int n_sm = 0;
  const cudaError_t attr =
      attn::device_once(state, decode_kernel<T, D, GT>, smem, &n_sm);
  if (attr != cudaSuccess) return attr;
  const long long ys = (long long)K * ((G + GT - 1) / GT);
  if (ys > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid((S + CHUNK - 1) / CHUNK, (unsigned)ys, B);
  decode_kernel<T, D, GT><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), lengths, static_cast<T*>(out), part,
      tickets, S, K, G, scale_log2);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(int GT, int G, const void* q, const void* kc,
                     const void* vc, const int* len, void* out, float* part,
                     int* tickets, int B, int S, int K, float sl,
                     cudaStream_t st) {
  switch (GT) {
    case 1: return launch<T, D, 1>(q, kc, vc, len, out, part, tickets, B,
                                   S, K, G, sl, st);
    case 2: return launch<T, D, 2>(q, kc, vc, len, out, part, tickets, B,
                                   S, K, G, sl, st);
    case 4: return launch<T, D, 4>(q, kc, vc, len, out, part, tickets, B,
                                   S, K, G, sl, st);
    case 8: return launch<T, D, 8>(q, kc, vc, len, out, part, tickets, B,
                                   S, K, G, sl, st);
    case 16:
      if constexpr (sizeof(T) == 2)          // the m16 rows of bf16 only
        return launch<T, D, 16>(q, kc, vc, len, out, part, tickets, B, S,
                                K, G, sl, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_d(int D, int GT, int G, const void* q, const void* kc,
                     const void* vc, const int* len, void* out, float* part,
                     int* tickets, int B, int S, int K, float sl,
                     cudaStream_t st) {
  return D == 128 ? launch_g<T, 128>(GT, G, q, kc, vc, len, out, part,
                                     tickets, B, S, K, sl, st)
                  : launch_g<T, 64>(GT, G, q, kc, vc, len, out, part,
                                    tickets, B, S, K, sl, st);
}

}  // namespace

// q (B, H, D), k_cache/v_cache (B, S, K, D), out (B, H, D), one dtype
// (bf16 when is_bf16, else fp32); lengths (B,) int32 valid positions.
// D in {64, 128}; any G = H / K; gt, the heads a block carries, in
// {1, 2, 4, 8} and 16 for bf16; chunk, the caller's keys per split,
// must be CHUNK (128). With T = ceil(G / gt) head tiles, part: fp32
// scratch of B * K * T * ceil(S / chunk) * gt * (D + 2) floats;
// tickets: B * K * T int32, zero on entry and left zero on return.
extern "C" int decode_attention_fwd(const void* q, const void* k_cache,
                                    const void* v_cache,
                                    const void* lengths, void* out,
                                    void* part, void* tickets, int B, int S,
                                    int H, int K, int D, int gt, int chunk,
                                    float scale, int is_bf16,
                                    void* stream) {
  if (B < 1 || S < 1 || K < 1 || H % K || (D != 64 && D != 128) ||
      chunk != CHUNK || gt < 1)
    return (int)cudaErrorInvalidValue;
  const int G = H / K;
  const float sl = scale * 1.4426950408889634f;   // exp -> exp2
  auto st = static_cast<cudaStream_t>(stream);
  auto len = static_cast<const int*>(lengths);
  auto pt = static_cast<float*>(part);
  auto tk = static_cast<int*>(tickets);
  if (is_bf16)
    return (int)launch_d<__nv_bfloat16>(D, gt, G, q, k_cache, v_cache, len,
                                        out, pt, tk, B, S, K, sl, st);
  return (int)launch_d<float>(D, gt, G, q, k_cache, v_cache, len, out, pt,
                              tk, B, S, K, sl, st);
}
