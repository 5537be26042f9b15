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
// in three launches: delta; dK/dV, one block per (64 keys, kv head,
// batch), which loops in a fixed order over the G query heads of the
// group and the q tiles from the keys' diagonal to S; dQ, one block per
// (128 (position, head) rows, kv head, batch), which loops over the kv
// tiles up to its causal frontier. Each output element is summed by one
// thread in a fixed order and written once: no atomics, so two launches
// on the same inputs give the same bits. Any S is taken (ragged tiles
// zero-filled by TMA and masked).
//
// What bounds it: 5 products of the forward's 2 over the S (S + 1) / 2
// causal pairs of each head (10 D operations a pair): at Qwen3-1.7B's
// train shape (B = 2, S = 4096, H = 16, K = 8, D = 128, bf16) 3.4e11
// operations, ~0.35 ms at the 989 TFLOP/s bf16 peak; its bytes (q, k, v,
// o, dO, lse in, dq, dk, dv out, ~202 MB) take ~0.060 ms at 3.35 TB/s.
// The kernels do 7 products (P is recomputed in each), 0.49 ms at peak.
// Measured on an "NVIDIA H100 80GB HBM3, 700.00 W" at that shape, card
// time in turns (chip_smoke.py): 0.8294 ms against SDPA's backward
// 0.8229 and 2.2488 for the mma.sync kernels this design replaced; 2.39x
// the bound (PERF.md section 6, row 8, has the latest run and the time
// of each kernel).
//
// bf16 design (wgmma_tma.cuh has the helpers and the tile layout), by
// what held the mma.sync kernels it replaces back:
// - wgmma, not mma.sync: every product is a 64-row warpgroup wgmma with
//   fp32 accumulators in registers. S^T = K Q^T and dP^T = V dO^T
//   (dK/dV), S = Q K^T and dP = dO V^T (dQ) read both operands from
//   shared memory, once for the warpgroup; P and dS are formed in
//   registers and feed dV += P^T dO, dK += dS^T Q and dQ += dS K as the
//   register A operand (the m64nNk16 accumulator layout packed to bf16
//   is that A layout), B read MN-major with the transpose bit.
// - Tiles of 64: 64 keys x 64 positions (dK/dV) and 64 rows x 64 keys
//   (dQ) a step, 64 x D accumulators. ptxas keeps these kernels within
//   168 registers a thread (the launch's count; it allocated no more
//   under setmaxnreg's 240), and a warpgroup holding both dK and dV (128
//   registers) had its wgmmas serialized. So the dK/dV block owns 64 keys
//   and splits them by warpgroup: warpgroup 0 holds dV and forms P^T,
//   which it hands to warpgroup 1 in shared memory (fp32, double
//   buffered, mbarriers); warpgroup 1 holds dK and forms dS^T. Four
//   products a step, two a warpgroup.
// - Warp specialisation: a block is two consumer warpgroups and one
//   producer warpgroup (setmaxnreg 240 / 24); the producer's first warp
//   issues the copies and the consumers only compute. The dK/dV
//   consumers are software-pipelined: step i + 1's shared-memory product
//   is issued with step i's register-A product, and step i + 1's
//   exponentials (or dS^T) are formed while it runs. (The dQ consumers'
//   registers leave no room for that: their S and dP are issued
//   together and the exponentials overlap dP.)
// - A TMA ring with mbarriers in place of one cp.async stage and a
//   block-wide barrier a step: K and V (dK/dV) or Q and dO (dQ) land
//   once; Q, dO (TMA), lse and delta (cp.async into the same barrier)
//   tiles (dK/dV, 4 stages) or K and V tiles (dQ, 3 stages) come in a
//   ring, each stage with a full barrier (bytes and arrivals) and an
//   empty barrier (one arrival a consumer warp). Tiles are 128-byte
//   swizzled boxes from 4-D tensor maps over (D, heads, S, B); the dQ
//   block's Q and dO are one box of (G heads x 128 / G positions), row =
//   position * G + head, so each K/V tile serves the whole GQA group.
//   Blocks launch longest first across all (kv head, sequence) pairs.
// - Seven products, not five: P is recomputed in both kernels, which is
//   what keeps every gradient element with one owner and no atomics (a
//   one-pass design would add dQ across kv tiles).
// fp32: exact fp32 FMAs on CUDA cores, as the forward's fp32 path: P^T
// and dS^T of a (32 keys, 8 rows) tile through shared memory in the
// dK/dV kernel, dS broadcast by shuffles in the dQ kernel.
#include "attn_mma.cuh"
#include "wgmma_tma.cuh"

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

// ---- delta = rowsum(dO * O) -----------------------------------------------

// fp32: a warp a (b, s, h) row
__global__ void __launch_bounds__(THREADS)
delta_f32_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                 float* __restrict__ delta, int S, int H, int D, long rows) {
  const long row = (long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* po = o + row * D;
  const float* pd = dout + row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(pd[c], po[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long bs = row / H;
    delta[(bs / S * H + row % H) * S + bs % S] = acc;
  }
}

// bf16: D / 8 lanes a row, 16 bytes of O and of dO each; 32 / (D / 8)
// rows a warp
template <int D>
__global__ void __launch_bounds__(THREADS)
delta_bf16_kernel(const __nv_bfloat16* __restrict__ o,
                  const __nv_bfloat16* __restrict__ dout,
                  float* __restrict__ delta, int S, int H, long rows) {
  constexpr int LPR = D / 8, RPW = 32 / LPR;
  const int lane = threadIdx.x & 31;
  const long row =
      ((long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5)) * RPW +
      lane / LPR;
  float acc = 0.f;
  if (row < rows) {
    const size_t off = row * D + (lane % LPR) * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(o + off);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + off);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = __bfloat1622float2(a2[i]);
      const float2 fg = __bfloat1622float2(g2[i]);
      acc = fmaf(fg.x, fa.x, acc);
      acc = fmaf(fg.y, fa.y, acc);
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && lane % LPR == 0) {
    const long bs = row / H;
    delta[(bs / S * H + row % H) * S + bs % S] = acc;
  }
}

// ---- bf16: wgmma fed by TMA, warp-specialised -----------------------------

constexpr int WG = 128;              // threads of a warpgroup
constexpr int CONSUMERS = 2;         // consumer warpgroups a block
constexpr int TC_THREADS = (CONSUMERS + 1) * WG;   // + the producer's
constexpr int TILE = 64;             // keys / positions / rows of a tile
constexpr int BOX = TILE * 128;      // bytes of a 64-row, 128-byte box
constexpr int BROWS = CONSUMERS * TILE;   // (position, head) rows of a dQ
                                          // block
constexpr int CONSUMER_REGS = 240;   // 2 x 128 x 240 + 128 x 24 = 168 a
constexpr int PRODUCER_REGS = 24;    // thread at the launch's 384 (ptxas
                                     // keeps these kernels within 168)
constexpr int MAX_G = 64;

// The dynamic shared memory of a kernel, its base 1024-byte aligned (the
// 128-byte swizzle repeats every 1024 bytes); declared in the kernel so
// that the compiler addresses it as shared memory (32-bit).
#define ALIGNED_SMEM(name) \
  extern __shared__ __align__(1024) unsigned char name[]

// Shared memory of the dK/dV kernel, bytes from the 1024-aligned base:
// K and V of the block's 64 keys ([half][64 rows][128 B] each), NST
// stages of the q ring (Q and dO [half][64 rows][128 B], lse and delta
// of the tile's 64 positions), two P^T buffers (fp32, 32 values a
// thread, 4 at a time thread-major), then the barriers.
template <int D, int NST>
struct DkdvSmem {
  static constexpr int HALVES = D / 64;
  static constexpr int KV = HALVES * BOX;        // one of K, V
  static constexpr int QT = HALVES * BOX;        // one of Q, dO a stage
  static constexpr int STAGE = 2 * QT + 1024;    // + lse, delta
  static constexpr int PT = WG * 32 * 4;         // a P^T buffer
  static constexpr int PBUF = 2 * KV + NST * STAGE;
  static constexpr int BARS = PBUF + 2 * PT;
  static constexpr int BYTES = BARS + (1 + 2 * NST + 4) * 8;
};

// Shared memory of the dQ kernel: Q and dO of the block's 128 rows
// ([half][128 rows][128 B] each), then NST stages of the K/V ring (K and
// V [half][64 keys][128 B]), then the barriers.
template <int D, int NST>
struct DqSmem {
  static constexpr int HALVES = D / 64;
  static constexpr int QR = HALVES * 2 * BOX;    // one of Q, dO
  static constexpr int KT = HALVES * BOX;        // one of K, V a stage
  static constexpr int STAGE = 2 * KT;
  static constexpr int BARS = 2 * QR + NST * STAGE;
  static constexpr int BYTES = BARS + (1 + 2 * NST) * 8;
};

// Two k16 steps' worth of fp32 accumulator (d[8kc .. 8kc + 7]) as the
// register A operand of a k16 step: bf16 pairs, row gid then gid + 8,
// then the next 8 columns.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&d)[N],
                                       int kc) {
  a[0] = attn::pack_bf16(d[8 * kc], d[8 * kc + 1]);
  a[1] = attn::pack_bf16(d[8 * kc + 2], d[8 * kc + 3]);
  a[2] = attn::pack_bf16(d[8 * kc + 4], d[8 * kc + 5]);
  a[3] = attn::pack_bf16(d[8 * kc + 6], d[8 * kc + 7]);
}

// acc (64 x D) += A B, A a k16 step in registers, B MN-major
template <int D>
__device__ __forceinline__ void rs_step(float (&acc)[D / 2],
                                        const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 128)
    hop::wgmma_rs_m64n128(acc, a, b, 1);
  else
    hop::wgmma_rs_m64n64(acc, a, b, 1);
}

// c (64 x 64) = A B^T over D: A the 64 rows of descriptor `a`, B the 64
// rows of `b`, both K-major, each row's second 64 columns (D 128) `half`
// bytes on; issued, not waited for. A descriptor's address field is the
// byte address / 16 (below 2^14 for any shared memory), so an offset is
// added to the descriptor itself.
template <int D>
__device__ __forceinline__ void ss_product(float (&c)[32], uint64_t a,
                                           int a_half, uint64_t b,
                                           int b_half) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int h = kk / 4, off = (kk % 4) * 32;
    hop::wgmma_ss_m64n64(c, a + ((h * a_half + off) >> 4),
                         b + ((h * b_half + off) >> 4), kk > 0);
  }
}

// A consumer warpgroup of the dK/dV kernel: WGI 0 holds dV and forms
// P^T, WGI 1 holds dK and forms dS^T (see the kernel); `out` is dV or
// dK. The index is a template argument, so each warpgroup's tile
// addresses and descriptors are the same in every thread of a warp.
// Software-pipelined: step i + 1's S^T (or dP^T) is issued right before
// step i's dV (or dK) product, and its exponentials (or dS^T) are
// formed while that product runs.
template <int D, int NST, int WGI>
__device__ __forceinline__ void dkdv_consumer(unsigned char* smem, int S,
                                              int K, int kh, int b, int k0,
                                              int n_qt, int G, float scale,
                                              __nv_bfloat16* out) {
  using L = DkdvSmem<D, NST>;
  const unsigned char* stages = smem + 2 * L::KV;
  float* pbuf = reinterpret_cast<float*>(smem + L::PBUF);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + NST;
  uint64_t* p_full = empty + NST;
  uint64_t* p_empty = p_full + 2;
  const int wt = threadIdx.x % WG, warp = wt / 32, lane = wt & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int key0 = k0 + warp * 16 + gid, key1 = key0 + 8;
  const float scale_log2 = scale * LOG2E;
  const int n = G * (n_qt - k0 / TILE);         // steps
  // A of this warpgroup's shared-memory product: K (S^T) or V (dP^T)
  const uint64_t a_desc =
      hop::desc_sw128(smem + (WGI == 0 ? 0 : L::KV), 0, 1024);
  auto stage = [&](int i) { return stages + (i % NST) * L::STAGE; };
  // c = K Q^T or V dO^T of step i, issued (its stage has landed)
  auto ss = [&](float (&c)[32], int i) {
    const unsigned char* sp = stage(i) + (WGI == 0 ? 0 : L::QT);
    ss_product<D>(c, a_desc, BOX, hop::desc_sw128(sp, 0, 1024), BOX);
    hop::wgmma_commit();
  };

  float acc[D / 2];                              // dV (wg 0) or dK (wg 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float c[32];                                   // S^T / dP^T of step i
  uint32_t a[4][4];                              // its P^T / dS^T, bf16
  hop::mbar_wait(kv_full, 0);
  hop::mbar_wait(full, 0);
  hop::fence_regs(c);
  hop::fence_regs(acc);
  hop::wgmma_fence();
  ss(c, 0);
  hop::wgmma_commit();                           // step -1's product: none
  int q0 = k0;                                   // step i's q tile
  // one step; NEXT: issue step i + 1's S^T / dP^T (all but the last).
  // The control flow between the fence and the wait that follow is
  // straight, so the compiler keeps the products in flight.
  auto step = [&](int i, auto next) {
    constexpr bool NEXT = decltype(next)::value;
    const unsigned char* sp = stage(i);
    // lse, then delta, of the tile's positions
    const float* ld = reinterpret_cast<const float*>(sp + 2 * L::QT);
    // this thread's P^T in the buffer of step i's parity: value 4 j + e at
    // [j][thread][e], float4s of consecutive threads side by side
    float4* pt = reinterpret_cast<float4*>(pbuf + (i & 1) * (L::PT / 4)) + wt;
    hop::wgmma_wait<1>();                        // c (step i) is done
    hop::fence_regs(c);
    if constexpr (WGI == 0) {
      // P^T in place of S^T; a mask on the diagonal tile and past S;
      // then to warpgroup 1 once it has read the buffer's last use
      const bool mask = q0 == k0 || q0 + TILE > S;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(ld + 8 * j + 2 * tig);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = q0 + 8 * j + 2 * tig + (e & 1);
          float p = hop::exp2_approx(fmaf(c[4 * j + e], scale_log2,
                                          -((e & 1) ? l2.y : l2.x) * LOG2E));
          if (mask && ((e < 2 ? key0 : key1) > pos || pos >= S)) p = 0.f;
          c[4 * j + e] = p;
        }
      }
      hop::mbar_wait(p_empty + (i & 1), ((i >> 1) & 1) ^ 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        pt[j * WG] = make_float4(c[4 * j], c[4 * j + 1], c[4 * j + 2],
                                 c[4 * j + 3]);
      hop::mbar_arrive(p_full + (i & 1));
    } else {
      // dS^T = P^T * (dP^T - delta) in place of dP^T
      hop::mbar_wait(p_full + (i & 1), (i >> 1) & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 p4 = pt[j * WG];
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
        const float2 d2 =
            *reinterpret_cast<const float2*>(ld + TILE + 8 * j + 2 * tig);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[4 * j + e] = p[e] * (c[4 * j + e] - ((e & 1) ? d2.y : d2.x));
      }
      hop::mbar_arrive(p_empty + (i & 1));
    }
    // step i - 1's product is done: its A registers and its stage free
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) hop::fence_regs(a[kc]);
    __syncwarp();
    if (i > 0 && lane == 0) hop::mbar_arrive(empty + (i - 1) % NST);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) pack_a(a[kc], c, kc);
    if constexpr (NEXT) hop::mbar_wait(full + (i + 1) % NST,
                                       ((i + 1) / NST) & 1);
    hop::fence_regs(c);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) hop::fence_regs(a[kc]);
    hop::wgmma_fence();
    if constexpr (NEXT) ss(c, i + 1);
    // dV += P^T dO (wg 0) or dK += dS^T Q (wg 1): A from registers
    // (the accumulator layout packed to bf16 pairs), B = dO / Q
    // MN-major (positions x D)
    const uint64_t bd =
        hop::desc_sw128(sp + (WGI == 0 ? L::QT : 0), BOX, 1024);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)             // 16 positions: 2048 bytes
      rs_step<D>(acc, a[kc], bd + kc * (2048 >> 4));
    hop::wgmma_commit();
    q0 = q0 + TILE < n_qt * TILE ? q0 + TILE : k0;
  };
  for (int i = 0; i < n - 1; ++i) step(i, std::true_type{});
  step(n - 1, std::false_type{});
  hop::wgmma_wait<0>();
  hop::fence_regs(acc);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) hop::fence_regs(a[kc]);
  __syncwarp();
  if (lane == 0) hop::mbar_arrive(empty + (n - 1) % NST);

  const float mul = WGI == 0 ? 1.f : scale;
  const int keys[2] = {key0, key1};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= S) continue;
    __nv_bfloat16* dst =
        out + (((size_t)b * S + keys[r]) * K + kh) * D + 2 * tig;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = attn::pack_bf16(
          acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// One block: keys k0 .. k0 + 63 of kv head kh, sequence b, over the G
// heads of the group in order, each over its q tiles of 64 positions
// from the keys' diagonal to S (the steps). Warpgroup 0 holds dV (64 x D
// fp32), forms S^T = K Q^T and P^T and hands P^T to warpgroup 1 through
// shared memory; warpgroup 1 holds dK, forms dP^T = V dO^T and dS^T;
// each then adds its product (dV += P^T dO, dK += dS^T Q) from
// registers. The producer warp loads K and V once, then the q ring.
template <int D, int NST>
__global__ void __launch_bounds__(TC_THREADS, 1)
dkdv_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                  __grid_constant__ const CUtensorMap tm_do,
                  __grid_constant__ const CUtensorMap tm_k,
                  __grid_constant__ const CUtensorMap tm_v,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int S, int H, int K, int G,
                  float scale) {
  using L = DkdvSmem<D, NST>;
  ALIGNED_SMEM(smem);
  unsigned char* ks = smem;
  unsigned char* vs = smem + L::KV;
  unsigned char* stages = smem + 2 * L::KV;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + NST;
  uint64_t* p_full = empty + NST;                // P^T written, by buffer
  uint64_t* p_empty = p_full + 2;                // P^T read

  // blocks in launch order: key tile 0 (the longest) of every (kv
  // head, sequence), then tile 1, ...
  const int n_qt = (S + TILE - 1) / TILE, kb = gridDim.x / n_qt;  // K x B
  const int qt0 = blockIdx.x / kb, k0 = qt0 * TILE;
  const int kh = blockIdx.x % kb % K, b = blockIdx.x % kb / K;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    if (hop::smem_u32(smem) % 1024) __trap();    // the swizzle's period
    hop::mbar_init(kv_full, 1);
    for (int i = 0; i < NST; ++i) {
      hop::mbar_init(full + i, 33);              // the producer warp's
                                                 // copies and its TMA
      hop::mbar_init(empty + i, CONSUMERS * 4);  // every consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      hop::mbar_init(p_full + i, WG);            // every thread of one
      hop::mbar_init(p_empty + i, WG);           // warpgroup
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (wg == CONSUMERS) {                         // producer
    hop::regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x - CONSUMERS * WG >= 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      hop::tma_prefetch(&tm_q);
      hop::tma_prefetch(&tm_do);
      hop::mbar_expect_tx(kv_full, 2 * L::KV);
#pragma unroll
      for (int h = 0; h < L::HALVES; ++h) {
        hop::tma_load_4d(ks + h * BOX, &tm_k, kv_full, h * 64, kh, k0, b);
        hop::tma_load_4d(vs + h * BOX, &tm_v, kv_full, h * 64, kh, k0, b);
      }
    }
    int it = 0;                                  // steps so far
    for (int h = kh * G; h < kh * G + G; ++h) {
      for (int q0 = k0; q0 < n_qt * TILE; q0 += TILE, ++it) {
        const int st = it % NST;
        hop::mbar_wait(empty + st, ((it / NST) & 1) ^ 1);
        unsigned char* sp = stages + st * L::STAGE;
        float* ls = reinterpret_cast<float*>(sp + 2 * L::QT);
        float* dl = ls + TILE;
        for (int r = lane; r < TILE; r += 32) {  // zeros past S
          const int pos = q0 + r;
          const size_t off = pos < S ? ((size_t)b * H + h) * S + pos : 0;
          hop::cp_async4(ls + r, lse + off, pos < S);
          hop::cp_async4(dl + r, delta + off, pos < S);
        }
        hop::cp_async_arrive(full + st);
        if (lane == 0) {
          hop::mbar_expect_tx(full + st, 2 * L::QT);
#pragma unroll
          for (int hh = 0; hh < L::HALVES; ++hh) {
            hop::tma_load_4d(sp + hh * BOX, &tm_q, full + st, hh * 64, h,
                             q0, b);
            hop::tma_load_4d(sp + L::QT + hh * BOX, &tm_do, full + st,
                             hh * 64, h, q0, b);
          }
        }
      }
    }
    return;
  }

  hop::regs_alloc<CONSUMER_REGS>();              // consumers
  if (wg == 0)
    dkdv_consumer<D, NST, 0>(smem, S, K, kh, b, k0, n_qt, G, scale, dv);
  else
    dkdv_consumer<D, NST, 1>(smem, S, K, kh, b, k0, n_qt, G, scale, dk);
}

// A consumer warpgroup of the dQ kernel: rows 64 WGI .. + 63 of the
// block's 128 (row = position * G + head), its dQ rows in registers. A
// tile's S and dP are issued together and its exponentials formed while
// dP runs; the dQ product is waited for before the next tile (tile t +
// 1's products issued ahead of it would not fit the registers beside
// dQ's). A warpgroup whose positions end before the block's last tiles
// waits for those tiles and frees them unread.
template <int D, int NST, int WGI>
__device__ __forceinline__ void dq_consumer(
    unsigned char* smem, int S, int H, int G, int P, int kh, int b,
    int q0, int n_tiles, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    float scale) {
  using L = DqSmem<D, NST>;
  const unsigned char* stages = smem + 2 * L::QR;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + NST;
  const int wt = threadIdx.x % WG, warp = wt / 32, lane = wt & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const float scale_log2 = scale * LOG2E;
  const int q_end = min(q0 + P, S), n_rows = P * G;
  // this thread's rows r0 (gid) and r1 (gid + 8) of the warp's 16
  const int r0 = WGI * TILE + warp * 16 + gid, r1 = r0 + 8;
  const int p0 = q0 + r0 / G, p1 = q0 + r1 / G;
  const bool ok0 = r0 < n_rows && p0 < S, ok1 = r1 < n_rows && p1 < S;
  const size_t st0 = ((size_t)b * H + kh * G + r0 % G) * S + p0;
  const size_t st1 = ((size_t)b * H + kh * G + r1 % G) * S + p1;
  const float l0 = ok0 ? lse[st0] * LOG2E : 0.f;
  const float l1 = ok1 ? lse[st1] * LOG2E : 0.f;
  const float d0 = ok0 ? delta[st0] : 0.f, d1 = ok1 ? delta[st1] : 0.f;
  // the warpgroup's positions
  const int w_first = q0 + WGI * TILE / G;
  const int w_last = min(q0 + min(WGI * TILE + TILE - 1, n_rows - 1) / G,
                         q_end - 1);
  const bool w_live = WGI * TILE < n_rows && w_first <= w_last;
  // A of the shared-memory products: the warpgroup's rows of Q, of dO
  const uint64_t qa = hop::desc_sw128(smem + WGI * BOX, 0, 1024);
  const uint64_t ga = hop::desc_sw128(smem + L::QR + WGI * BOX, 0, 1024);

  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  hop::mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % NST, k0 = t * TILE;
    hop::mbar_wait(full + st, (t / NST) & 1);
    if (w_live && k0 <= w_last) {
      const unsigned char* kt = stages + st * L::STAGE;
      // S = Q K^T and dP = dO V^T: 64 rows x 64 keys
      float s[32], dp[32];                      // the first k step
      hop::fence_regs(s);                       // overwrites them
      hop::fence_regs(dp);
      hop::wgmma_fence();
      ss_product<D>(s, qa, 2 * BOX, hop::desc_sw128(kt, 0, 1024), BOX);
      hop::wgmma_commit();
      ss_product<D>(dp, ga, 2 * BOX, hop::desc_sw128(kt + L::KT, 0, 1024),
                    BOX);
      hop::wgmma_commit();
      const bool mask = k0 + TILE - 1 > w_first;
      hop::wgmma_wait<1>();
      hop::fence_regs(s);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * tig + (e & 1);
          float p = hop::exp2_approx(
              fmaf(s[4 * j + e], scale_log2, -(e < 2 ? l0 : l1)));
          if (mask && key > (e < 2 ? p0 : p1)) p = 0.f;
          s[4 * j + e] = p;
        }
      // dS = P * (dP - delta) in place of S
      hop::wgmma_wait<0>();
      hop::fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = s[i] * (dp[i] - ((i & 2) ? d1 : d0));
      // dQ += dS K: A from registers, B = K MN-major (keys x D)
      uint32_t a[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        pack_a(a[kc], s, kc);
        hop::fence_regs(a[kc]);
      }
      const uint64_t kb = hop::desc_sw128(kt, BOX, 1024);
      hop::fence_regs(dqa);
      hop::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)          // 16 keys: 2048 bytes
        rs_step<D>(dqa, a[kc], kb + kc * (2048 >> 4));
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(dqa);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) hop::fence_regs(a[kc]);
    }
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(empty + st);
  }

  const int rows[2] = {r0, r1}, pos[2] = {p0, p1};
  const bool ok[2] = {ok0, ok1};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!ok[r]) continue;
    __nv_bfloat16* dst =
        dq + (((size_t)b * S + pos[r]) * H + kh * G + rows[r] % G) * D +
        2 * tig;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = attn::pack_bf16(
          dqa[4 * j + 2 * r] * scale, dqa[4 * j + 2 * r + 1] * scale);
  }
}

// One block: q tile n_qt - 1 - blockIdx.x (the longest first) of P =
// 128 / G positions x the G heads of kv head kh as its 128 rows (row =
// position * G + head; the rows past P * G are not loaded and not
// written), sequence b. Warpgroups 0 and 1 own rows 64 w .. + 63 (their
// dQ rows in registers); warpgroup 2's first warp loads Q and dO once
// (one box of G heads x P positions) and the K/V ring, a 64-key tile a
// step up to the block's causal frontier.
template <int D, int NST>
__global__ void __launch_bounds__(TC_THREADS, 1)
dq_wgmma_kernel(__grid_constant__ const CUtensorMap tm_qg,
                __grid_constant__ const CUtensorMap tm_dog,
                __grid_constant__ const CUtensorMap tm_k,
                __grid_constant__ const CUtensorMap tm_v,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int S, int H, int K, int G,
                int P, float scale) {
  using L = DqSmem<D, NST>;
  ALIGNED_SMEM(smem);
  unsigned char* qs = smem;
  unsigned char* gs = smem + L::QR;
  unsigned char* stages = smem + 2 * L::QR;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + NST;

  // blocks in launch order: the last q tile (the longest) of every (kv
  // head, sequence), then the one before, ...
  const int n_qt = (S + P - 1) / P, kb = gridDim.x / n_qt;   // K x B
  const int q0 = (n_qt - 1 - blockIdx.x / kb) * P;
  const int kh = blockIdx.x % kb % K, b = blockIdx.x % kb / K;
  const int q_end = min(q0 + P, S), n_rows = P * G;
  const int n_tiles = (q_end - 1) / TILE + 1;    // up to the frontier
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    if (hop::smem_u32(smem) % 1024) __trap();
    hop::mbar_init(q_full, 1);
    for (int i = 0; i < NST; ++i) {
      hop::mbar_init(full + i, 1);
      hop::mbar_init(empty + i, CONSUMERS * 4);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (wg == CONSUMERS) {                         // producer
    hop::regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x - CONSUMERS * WG != 0) return;
    hop::tma_prefetch(&tm_k);
    hop::tma_prefetch(&tm_v);
    hop::mbar_expect_tx(q_full, 2 * L::HALVES * n_rows * 128);
#pragma unroll
    for (int h = 0; h < L::HALVES; ++h) {
      hop::tma_load_4d(qs + h * 2 * BOX, &tm_qg, q_full, h * 64, kh * G,
                       q0, b);
      hop::tma_load_4d(gs + h * 2 * BOX, &tm_dog, q_full, h * 64, kh * G,
                       q0, b);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % NST;
      hop::mbar_wait(empty + st, ((t / NST) & 1) ^ 1);
      unsigned char* sp = stages + st * L::STAGE;
      hop::mbar_expect_tx(full + st, L::STAGE);
#pragma unroll
      for (int h = 0; h < L::HALVES; ++h) {
        hop::tma_load_4d(sp + h * BOX, &tm_k, full + st, h * 64, kh,
                         t * TILE, b);
        hop::tma_load_4d(sp + L::KT + h * BOX, &tm_v, full + st, h * 64, kh,
                         t * TILE, b);
      }
    }
    return;
  }

  hop::regs_alloc<CONSUMER_REGS>();              // consumers
  if (wg == 0)
    dq_consumer<D, NST, 0>(smem, S, H, G, P, kh, b, q0, n_tiles, lse,
                           delta, dq, scale);
  else
    dq_consumer<D, NST, 1>(smem, S, H, G, P, kh, b, q0, n_tiles, lse,
                           delta, dq, scale);
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime
// (the library links the runtime only), once a process.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static std::once_flag once;
  static EncodeTiled enc = nullptr;
  static cudaError_t err = cudaSuccess;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got{};
#if CUDART_VERSION >= 12050
    err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                           12000, cudaEnableDefault, &got);
#else
    err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                  cudaEnableDefault, &got);
#endif
    if (err == cudaSuccess && (got != cudaDriverEntryPointSuccess || !p))
      err = cudaErrorSymbolNotFound;
    enc = reinterpret_cast<EncodeTiled>(p);
  });
  *fn = enc;
  return err;
}

// A bf16 (B, S, N, D) tensor as a 4-D map (D, N, S, B), boxes of 64
// columns x n_box of N x s_box positions, 128-byte swizzled; elements
// out of bounds load as zeros.
cudaError_t map4(EncodeTiled enc, CUtensorMap* m, const void* base, int B,
                 int S, int N, int D, int n_box, int s_box) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)N * D * 2,
                                 (cuuint64_t)S * N * D * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)n_box, (cuuint32_t)s_box, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(base), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// G within the dQ block's rows, and 16-byte bases, which TMA and the
// delta pass's loads want
bool wgmma_takes(const void* q, const void* k, const void* v,
                 const void* o, const void* dout, int G) {
  const void* bases[5] = {q, k, v, o, dout};
  for (const void* p : bases)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return G <= MAX_G;
}

constexpr int DKDV_STAGES = 4;
constexpr int DQ_STAGES = 3;

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, void* dk, void* dv,
                         int B, int S, int H, int K, float scale,
                         cudaStream_t stream) {
  constexpr size_t smem_kv = DkdvSmem<D, DKDV_STAGES>::BYTES;
  constexpr size_t smem_q = DqSmem<D, DQ_STAGES>::BYTES;
  static attn::DeviceOnce st_kv, st_q;
  int n_sm = 0;
  cudaError_t err = attn::device_once(
      st_kv, dkdv_wgmma_kernel<D, DKDV_STAGES>, smem_kv, &n_sm);
  if (err != cudaSuccess) return err;
  err = attn::device_once(st_q, dq_wgmma_kernel<D, DQ_STAGES>, smem_q,
                          &n_sm);
  if (err != cudaSuccess) return err;
  const int G = H / K;
  EncodeTiled enc = nullptr;
  err = encoder(&enc);
  if (err != cudaSuccess) return err;
  const int P = BROWS / G;                   // positions of a dQ block
  CUtensorMap tq, tdo, tqg, tdog, tk, tv;
  if ((err = map4(enc, &tq, q, B, S, H, D, 1, TILE)) != cudaSuccess ||
      (err = map4(enc, &tdo, dout, B, S, H, D, 1, TILE)) != cudaSuccess ||
      (err = map4(enc, &tqg, q, B, S, H, D, G, P)) != cudaSuccess ||
      (err = map4(enc, &tdog, dout, B, S, H, D, G, P)) != cudaSuccess ||
      (err = map4(enc, &tk, k, B, S, K, D, 1, TILE)) != cudaSuccess ||
      (err = map4(enc, &tv, v, B, S, K, D, 1, TILE)) != cudaSuccess)
    return err;
  dkdv_wgmma_kernel<D, DKDV_STAGES>
      <<<(S + TILE - 1) / TILE * K * B, TC_THREADS, smem_kv,
         stream>>>(tq, tdo, tk, tv, lse, delta,
                   static_cast<__nv_bfloat16*>(dk),
                   static_cast<__nv_bfloat16*>(dv), S, H, K, G, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_wgmma_kernel<D, DQ_STAGES>
      <<<(S + P - 1) / P * K * B, TC_THREADS, smem_q, stream>>>(
          tqg, tdog, tk, tv, lse, delta, static_cast<__nv_bfloat16*>(dq),
          S, H, K, G, P, scale);
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
  if (is_bf16 && !wgmma_takes(q, k, v, o, dout, H / K))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const long rows = (long)B * S * H;
  if (is_bf16) {
    const auto* ob = static_cast<const __nv_bfloat16*>(o);
    const auto* gb = static_cast<const __nv_bfloat16*>(dout);
    const long per = (THREADS / 32) * (32 / (D / 8));   // rows a block
    const dim3 grid((unsigned)((rows + per - 1) / per));
    if (D == 128)
      delta_bf16_kernel<128><<<grid, THREADS, 0, s>>>(ob, gb, delta, S, H,
                                                      rows);
    else
      delta_bf16_kernel<64><<<grid, THREADS, 0, s>>>(ob, gb, delta, S, H,
                                                     rows);
  } else {
    const dim3 grid((unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)));
    delta_f32_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout),
        delta, S, H, D, rows);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (is_bf16)
    return (int)(D == 128
                     ? launch_wgmma<128>(q, k, v, dout, lse, delta, dq, dk,
                                         dv, B, S, H, K, scale, s)
                     : launch_wgmma<64>(q, k, v, dout, lse, delta, dq, dk, dv,
                                        B, S, H, K, scale, s));
  return (int)(D == 128 ? launch_f32<128>(q, k, v, dout, lse, delta, dq, dk,
                                          dv, B, S, H, K, scale, s)
                        : launch_f32<64>(q, k, v, dout, lse, delta, dq, dk,
                                         dv, B, S, H, K, scale, s));
}

// The bf16 kernels' launch facts on the current device at head dim D:
// out = {dK/dV blocks an SM, its dynamic shared memory in bytes, dQ
// blocks an SM, its shared memory, threads a block}.
extern "C" int flash_attention_bwd_info(int D, int* out) {
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  auto fill = [&](auto kernel, size_t smem, attn::DeviceOnce& st, int* o) {
    int n_sm = 0;
    cudaError_t err = attn::device_once(st, kernel, smem, &n_sm);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(o, kernel,
                                                          TC_THREADS, smem);
    o[1] = (int)smem;
    return err;
  };
  static attn::DeviceOnce st[4];
  cudaError_t err;
  if (D == 128) {
    err = fill(dkdv_wgmma_kernel<128, DKDV_STAGES>,
               DkdvSmem<128, DKDV_STAGES>::BYTES, st[0], out);
    if (err == cudaSuccess)
      err = fill(dq_wgmma_kernel<128, DQ_STAGES>,
                 DqSmem<128, DQ_STAGES>::BYTES, st[1], out + 2);
  } else {
    err = fill(dkdv_wgmma_kernel<64, DKDV_STAGES>,
               DkdvSmem<64, DKDV_STAGES>::BYTES, st[2], out);
    if (err == cudaSuccess)
      err = fill(dq_wgmma_kernel<64, DQ_STAGES>,
                 DqSmem<64, DQ_STAGES>::BYTES, st[3], out + 2);
  }
  out[4] = TC_THREADS;
  return (int)err;
}
