// Tensor-core and asynchronous-copy helpers shared by the kernels that run
// bf16 products on mma.sync (convbn_bwd.cu, lstm_bwd_mma.cu,
// lstm_fwd_mma.cu, lstm_wide.cu) and by lstm_bwd_f32.cu's cp.async
// staging, and the ordered sum of per-block partials (ordered_sum) that
// convbn_bwd.cu, lstm_bwd_f32.cu, lstm_bwd_mma.cu and lstm_wide.cu launch
// in place of float atomics, sm_90a.
//
// mma.sync.m16n8k16 fragment layouts (g = lane / 4, q = lane % 4; a 32-bit
// register holds two bf16, the lower column or depth index in its low half):
//   A (16 x 16, row-major): a0 = (g, 2q..2q+1), a1 = (g+8, 2q..2q+1),
//                           a2 = (g, 2q+8..2q+9), a3 = (g+8, 2q+8..2q+9)
//   B (16 x 8, col-major):  b0 = (k 2q..2q+1, n g), b1 = (k 2q+8..2q+9, n g)
//   C (16 x 8, f32):        c0, c1 = (g, 2q..2q+1), c2, c3 = (g+8, 2q..2q+1)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned short bf16_bits;  // staged bf16 values, by their bits

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), f32 accumulators
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// cp.async: 16 bytes, or 4 bytes with zero fill where !valid (src is then
// not read); commit and wait on groups
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// out[e] = the sum over parts of partials[part][e] (n_elems floats a part),
// in part order: no atomics, so a repeated call gives the same bits. kRun
// > 0 sums runs of kRun parts apart, then the runs (short chains keep the
// f32 error down); kRun = 0 sums the parts in one chain. One thread an
// element.
template <int kRun>
__global__ void ordered_sum(const float* __restrict__ partials,
                            float* __restrict__ out, int n_parts,
                            int n_elems) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elems) return;
  float s = 0.f;
  if constexpr (kRun == 0) {
    for (int p = 0; p < n_parts; ++p) s += partials[(size_t)p * n_elems + e];
  } else {
    for (int p0 = 0; p0 < n_parts; p0 += kRun) {
      const int p1 = min(n_parts, p0 + kRun);
      float run = 0.f;
      for (int p = p0; p < p1; ++p) run += partials[(size_t)p * n_elems + e];
      s += run;
    }
  }
  out[e] = s;
}

template <int kRun>
void launch_ordered_sum(const float* partials, float* out, int n_parts,
                        int n_elems, cudaStream_t stream) {
  ordered_sum<kRun><<<(n_elems + 255) / 256, 256, 0, stream>>>(
      partials, out, n_parts, n_elems);
}

}  // namespace
