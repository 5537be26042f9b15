// Tensor-core and async-copy helpers shared by the attention kernels
// (flash_attention.cu, decode_attention.cu), sm_80+ PTX that Hopper
// runs: cp.async with zero fill, ldmatrix (plain and transposed) and
// mma.sync m16n8k16 with bf16 inputs and fp32 accumulators; and the
// host's per-device launch state.
//
// Fragment layout of mma.m16n8k16 (lane = 4 * gid + tig):
//   A (16 x 16, row-major): a0 = (gid, 2tig..2tig+1), a1 = (gid+8, same),
//                           a2 = (gid, 8+2tig..), a3 = (gid+8, 8+2tig..)
//   B (16 x 8, k x n):      b0 = (k 2tig..2tig+1, n gid), b1 = (k 8+2tig..)
//   C (16 x 8, fp32):       c0, c1 = (gid, 2tig..), c2, c3 = (gid+8, 2tig..)
// Shared-memory tiles are row-major with rows padded by 16 bytes, so
// the eight 16-byte rows one ldmatrix phase reads fall on distinct
// banks (a 256-byte row would put all eight on the same four).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

namespace attn {

// ---- per-device launch state (host) --------------------------------------
// A kernel's shared-memory attribute and the card's SM count belong to
// the device current at the launch (the wrapper makes its tensors'
// device current), so each is set or read once on every device a
// launch runs on, in arrays indexed by the device ordinal.
constexpr int MAX_DEVICES = 64;

struct DeviceOnce {
  std::once_flag once[MAX_DEVICES];
  cudaError_t err[MAX_DEVICES];
  int n_sm[MAX_DEVICES];
};

// Raise ``kernel``'s dynamic shared-memory limit to ``smem`` and read the
// SM count, once on the current device; the count goes to *n_sm.
template <typename Kernel>
inline cudaError_t device_once(DeviceOnce& st, Kernel kernel, size_t smem,
                               int* n_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(st.once[dev], [&] {
    st.err[dev] = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (st.err[dev] == cudaSuccess)
      st.err[dev] = cudaDeviceGetAttribute(
          &st.n_sm[dev], cudaDevAttrMultiProcessorCount, dev);
  });
  *n_sm = st.n_sm[dev];
  return st.err[dev];
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; when !valid nothing is read and the
// 16 bytes are zero-filled (masked rows hold zeros, never garbage).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i receives (row lane/4, cols 2(lane%4)..+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// As ldmatrix_x4, each matrix transposed: register i receives
// (rows 2(lane%4)..+1, col lane/4) of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a * b on the tensor cores (bf16 in, fp32 accumulate).
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to a bf16 pair; `lo` takes the lower column.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace attn
