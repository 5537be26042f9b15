// Shared device code of the IVF band scan (csrc/ivf_scan.cu) and the
// fused two-tier probe (csrc/fused_serve.cu).
//
// Candidates are ordered by (score desc, id asc), one total order for
// every selection step. A (score, id) pair is packed into one 64-bit
// key whose unsigned ascending order is exactly that order, so a block
// selects its top candidates with a plain bitonic sort of keys in
// shared memory, and equal pairs (the (NEG, -1) pads) sort together.
//
// Scores are dot products accumulated in fp64 and rounded once to
// fp32. Every product of an int8 code (or a bf16 tier value) with an
// fp32 query component is exact in fp64, so the rounded sum does not
// depend on the order of the 64 additions: the kernel and its plain
// PyTorch version give the same fp32 score, and the same selection,
// whatever order each sums in. The scan is memory-bound, so the fp64
// FMAs cost nothing that shows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace ivf_band {

constexpr int THREADS = 256;
constexpr float NEG = -2.0f;                // below any cosine
constexpr unsigned long long EMPTY = ~0ull;  // sorts after every key

__device__ __forceinline__ unsigned long long make_key(float v, int id) {
  if (v == 0.f) v = 0.f;                    // -0 and +0 compare equal
  unsigned u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending floats
  return (static_cast<unsigned long long>(~u) << 32) |
         static_cast<unsigned>(id + 1);     // id -1 (pad) -> 0
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  unsigned u = ~static_cast<unsigned>(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_id(unsigned long long key) {
  return static_cast<int>(static_cast<unsigned>(key & 0xffffffffu)) - 1;
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Ascending bitonic sort of n (a power of two) keys in shared memory by
// the whole block. Callers write the keys, then call this (it starts
// with a barrier).
__device__ inline void bitonic_sort(unsigned long long* keys, int n) {
  __syncthreads();
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const unsigned long long a = keys[i], b = keys[p];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// fp64 dot of one row of T (16-byte aligned, d a multiple of 16 bytes'
// worth of T) with the fp64 query in shared memory.
template <typename T>
__device__ __forceinline__ double load_dot(const T* row, const double* qs,
                                           int d);

template <>
__device__ __forceinline__ double load_dot<int8_t>(const int8_t* row,
                                                   const double* qs,
                                                   int d) {
  double acc = 0.0;
  const int4* r16 = reinterpret_cast<const int4*>(row);
  for (int j0 = 0; j0 < d; j0 += 16) {
    const int4 w = __ldg(r16 + (j0 >> 4));
    const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int code =
            static_cast<signed char>((words[u] >> (8 * b)) & 0xff);
        acc = fma(static_cast<double>(code), qs[j0 + 4 * u + b], acc);
      }
    }
  }
  return acc;
}

template <>
__device__ __forceinline__ double load_dot<__nv_bfloat16>(
    const __nv_bfloat16* row, const double* qs, int d) {
  double acc = 0.0;
  const int4* r16 = reinterpret_cast<const int4*>(row);
  for (int j0 = 0; j0 < d; j0 += 8) {
    const int4 w = __ldg(r16 + (j0 >> 3));
    const unsigned words[4] = {static_cast<unsigned>(w.x),
                               static_cast<unsigned>(w.y),
                               static_cast<unsigned>(w.z),
                               static_cast<unsigned>(w.w)};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      // a bf16 is the high half of an fp32: widening is exact
      const float lo = __uint_as_float(words[u] << 16);
      const float hi = __uint_as_float(words[u] & 0xffff0000u);
      acc = fma(static_cast<double>(lo), qs[j0 + 2 * u], acc);
      acc = fma(static_cast<double>(hi), qs[j0 + 2 * u + 1], acc);
    }
  }
  return acc;
}

// Score one band of `rows` rows against the normalized query `qs`
// (d doubles in shared memory), write every row's key into `keys`
// (padded with EMPTY up to n = pow2_at_least(rows)), sort, and copy the
// best `c_out` keys to `out`. Row r is a (d,) vector of T at
// `vals + r * d`; its score is fp32(dot) * scale[r] (scale == nullptr:
// no scale), and an id < 0 scores NEG.
template <typename T>
__device__ inline void score_band(const T* __restrict__ vals,
                                  const float* __restrict__ scale,
                                  const int* __restrict__ ids, int rows,
                                  int d, const double* qs,
                                  unsigned long long* keys, int c_out,
                                  unsigned long long* __restrict__ out) {
  const int n = pow2_at_least(rows);
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    unsigned long long key = EMPTY;
    if (r < rows) {
      const int id = __ldg(ids + r);
      float v = NEG;
      if (id >= 0) {
        v = __double2float_rn(load_dot<T>(vals + (size_t)r * d, qs, d));
        if (scale != nullptr) v = v * __ldg(scale + r);
      }
      key = make_key(v, id < 0 ? -1 : id);
    }
    keys[r] = key;
  }
  bitonic_sort(keys, n);
  for (int j = threadIdx.x; j < c_out; j += blockDim.x) out[j] = keys[j];
}

// Load query row `q` (d fp32, already L2-normalized by the caller) into
// shared memory as fp64.
__device__ __forceinline__ void load_query(const float* __restrict__ q,
                                           int d, double* qs) {
  for (int j = threadIdx.x; j < d; j += blockDim.x)
    qs[j] = static_cast<double>(q[j]);
}

// Merge `n_lists` sorted lists of `c_in` keys each (contiguous at
// `part`) into the best `c_out` (score, id) pairs; absent candidates
// flush as (NEG, -1).
__device__ inline void merge_lists(
    const unsigned long long* __restrict__ part, int n_lists, int c_in,
    int c_out, unsigned long long* keys, float* __restrict__ out_v,
    int* __restrict__ out_i) {
  const int m = n_lists * c_in;
  const int n = pow2_at_least(m);
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    keys[j] = j < m ? part[j] : EMPTY;
  bitonic_sort(keys, n);
  for (int j = threadIdx.x; j < c_out; j += blockDim.x) {
    const unsigned long long key = keys[j];
    const float v = key == EMPTY ? NEG : key_value(key);
    const bool absent = key == EMPTY || v == NEG;
    out_v[j] = absent ? NEG : v;
    out_i[j] = absent ? -1 : key_id(key);
  }
}

inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace ivf_band
