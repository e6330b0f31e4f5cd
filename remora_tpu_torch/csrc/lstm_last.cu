// Last-only LSTM forward for inference on Hopper (sm_90a), f32 leg.
//
// Replaces the TPU kernel remora_tpu/kernels/pallas_lstm.py::_fwd_kernel_last
// (launched by _fwd_last_call, API lstm_last_fused) for f32; bf16 runs
// lstm_fwd_mma.cu's tensor-core recurrence in its last-only form. It
// returns only h_{T-1} (B, H) of a single-layer forward LSTM over x (T, B,
// C):
//
//   gates_t = [x_t ; h_{t-1}] @ W_aug[:C+H] + W_aug[C+H]     (B, 4H), i|f|g|o
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
//   h_t = sigmoid(o) * tanh(c_t)
//
// Design:
//   * one launch covers the whole time loop, exactly T steps (no time
//     chunking, so no padding steps to gate);
//   * each block owns kRows batch rows and stages W_aug[:C+H] in dynamic
//     shared memory once, interleaved by hidden unit ([k][u][gate]) so a
//     thread reads its unit's four gate weights with one vector load;
//   * the matmul operand [x_t ; h_{t-1}] lives in shared memory, k-major,
//     double-buffered: step t reads one buffer while h_t and x_{t+1} (loaded
//     from global memory into registers before the step's matmul) go into
//     the other, so a step needs one barrier;
//   * thread (row group, unit) keeps its rows' c and h in f32 registers;
//     only h_{T-1} is written back;
//   * full-f32 FMAs (the Pallas kernel pins Precision.HIGHEST).
//
// Bound at the main-path shape (T=124, B=2048, C=H=64): 2*T*B*(C+H)*4H =
// 16.6 GFLOP and 65 MB of x. It runs on the
// non-tensor FP32 pipes (67 TFLOP/s on H100 SXM): >= 0.25 ms, operations
// bound; the bytes alone need ~19 us at 3.35 TB/s. Per step a block does
// 16 x 128 x 256 FMAs; the inner loop issues two shared-memory vector loads
// per 16 FMAs, so shared-memory bandwidth and FMA issue are roughly
// balanced. The recurrence is serial in T, so the block count (B / 16 =
// 128 blocks at B = 2048, one per SM) is the parallelism; tensor cores
// (wgmma) and TMA staging are left for a later kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;          // batch rows per block
constexpr int kRowsPerThread = 4;  // rows whose c/h one thread carries
constexpr int kRowGroups = kRows / kRowsPerThread;
constexpr int kMaxH = kThreads / kRowGroups;  // one (row group, unit) per thread
constexpr int kXPerThread = 8;                // x_t elements staged per thread
constexpr int kMaxC = kThreads * kXPerThread / kRows;

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// four consecutive operands (16-byte aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

template <typename T>
size_t smem_bytes(int C, int H) {
  const size_t K = C + H;
  return K * 4 * H * sizeof(T)        // W_aug[:C+H], interleaved
         + 2 * K * kRows * sizeof(T)  // [x_t ; h_{t-1}], two buffers
         + 4 * H * sizeof(float);     // bias row
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_last_kernel(const T* __restrict__ x, const T* __restrict__ w_aug,
                     T* __restrict__ out, int n_steps, int B, int C, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = C + H;
  const int G = 4 * H;
  T* ws = reinterpret_cast<T*>(smem);                        // [K][H][4]
  T* xh = ws + (size_t)K * G;                                // [2][K][kRows]
  float* bias = reinterpret_cast<float*>(xh + 2 * K * kRows);  // [H][4]

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kRows;
  for (int e = tid; e < K * G; e += kThreads) {
    const int k = e / G, j = e % G;
    ws[(k * H + j % H) * 4 + j / H] = w_aug[e];
  }
  for (int j = tid; j < G; j += kThreads) {
    bias[(j % H) * 4 + j / H] = to_f32(w_aug[(size_t)K * G + j]);
  }

  // this block's rows of one time step are kRows * C contiguous elements
  const int n_x = kRows * C;
  const int n_valid = min(kRows, B - b0) * C;
  const T* x_tile = x + (size_t)b0 * C;
  const size_t x_step = (size_t)B * C;
  for (int e = tid; e < n_x; e += kThreads) {
    xh[(e % C) * kRows + e / C] = e < n_valid ? x_tile[e] : from_f32<T>(0.f);
  }
  for (int e = tid; e < H * kRows; e += kThreads) {
    xh[C * kRows + e] = from_f32<T>(0.f);  // h_{-1} = 0
  }

  const bool active = tid < kRowGroups * H;
  const int u = tid % H;
  const int r0 = (tid / H) * kRowsPerThread;
  float c[kRowsPerThread], h[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) c[i] = h[i] = 0.f;
  __syncthreads();
  const float4 b4 = active ? make_float4(bias[4 * u], bias[4 * u + 1],
                                         bias[4 * u + 2], bias[4 * u + 3])
                           : make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < n_steps; ++t) {
    const T* cur = xh + (t & 1) * K * kRows;
    T* nxt = xh + ((t + 1) & 1) * K * kRows;

    // x_{t+1} into registers now; stored after the matmul
    T xr[kXPerThread];
    const bool more = t + 1 < n_steps;
#pragma unroll
    for (int i = 0; i < kXPerThread; ++i) {
      const int e = tid + i * kThreads;
      xr[i] = (more && e < n_valid) ? x_tile[(size_t)(t + 1) * x_step + e]
                                    : from_f32<T>(0.f);
    }

    if (active) {
      float acc[kRowsPerThread][4];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        acc[i][0] = b4.x;
        acc[i][1] = b4.y;
        acc[i][2] = b4.z;
        acc[i][3] = b4.w;
      }
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float4 w = load4(ws + (k * H + u) * 4);
        const float4 v = load4(cur + k * kRows + r0);
        const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          acc[i][0] = fmaf(xv[i], w.x, acc[i][0]);
          acc[i][1] = fmaf(xv[i], w.y, acc[i][1]);
          acc[i][2] = fmaf(xv[i], w.z, acc[i][2]);
          acc[i][3] = fmaf(xv[i], w.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float ig = sigmoid(acc[i][0]);
        const float fg = sigmoid(acc[i][1]);
        const float gg = tanhf(acc[i][2]);
        const float og = sigmoid(acc[i][3]);
        c[i] = fg * c[i] + ig * gg;
        h[i] = og * tanhf(c[i]);
        nxt[(C + u) * kRows + r0 + i] = from_f32<T>(h[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kXPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < n_x) nxt[(e % C) * kRows + e / C] = xr[i];
    }
    __syncthreads();
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = b0 + r0 + i;
      if (row < B) out[(size_t)row * H + u] = from_f32<T>(h[i]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w_aug, void* out, int n_steps, int B,
           int C, int H, void* stream) {
  if (n_steps < 0 || B < 1 || C < 1 || H < 1 || C > kMaxC || H > kMaxH) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes<T>(C, H);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_last_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + kRows - 1) / kRows;
  lstm_last_kernel<T><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_aug),
      static_cast<T*>(out), n_steps, B, C, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = launched).
int lstm_last_f32(const void* x, const void* w_aug, void* out, int n_steps,
                  int B, int C, int H, void* stream) {
  return launch<float>(x, w_aug, out, n_steps, B, C, H, stream);
}

int lstm_last_max_c(void) { return kMaxC; }
int lstm_last_max_h(void) { return kMaxH; }

const char* lstm_last_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
