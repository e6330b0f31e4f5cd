// LSTM forward (K2) for training on Hopper (sm_90a), its f32 leg.
//
// Replaces remora_tpu/kernels/pallas_lstm.py::_fwd_kernel /
// _fwd_kernel_nocs (launched by _fwd_call): the full forward of a
// single-layer LSTM over x (T, B, C), writing every hidden state hs (T, B, H)
// and, for the backward, every cell state cs. Only its f32 leg is here
// (lstm_fwd_f32); bf16 runs lstm_fwd_mma.cu's tensor-core recurrence. The
// backward (K3) is lstm_bwd_f32.cu in f32 and lstm_bwd_mma.cu in bf16.
//
//   gates_t = [x_t ; h_{t-1}] @ W_aug[:C+H] + W_aug[C+H]     (B, 4H), i|f|g|o
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
//   h_t = sigmoid(o) * tanh(c_t)
//
// Design:
//   * one launch walks all T steps; each block owns kRows = 16 batch rows
//     and stages W_aug[:C+H] in dynamic shared memory once, interleaved by
//     hidden unit (row k holds [u][gate]) so a thread reads its unit's four
//     gate weights with one vector load (row stride padded by four
//     elements);
//   * the matmul operand [x_t ; h_{t-1}] lives in shared memory, k-major,
//     double-buffered; the next step's x is loaded from global memory into
//     registers before the step's arithmetic and stored after it;
//   * full-f32 FMAs (the Pallas kernels pin Precision.HIGHEST).
// It is the inference kernel lstm_last.cu with per-step stores: thread
// (row group, unit) keeps its 4 rows' c and h in f32 registers and writes
// hs[t] (and cs[t] when kCs), coalesced along the unit.
//
// Bound at the main-path shape (T=124, B=2048, C=H=64) on an H100 SXM
// (67 TFLOP/s FP32, 3.35 TB/s), with cs: 2*T*B*(C+H)*4H = 16.64 GFLOP; x +
// hs + cs = 195 MB -> >= 0.248 ms (operations). The products run on the
// FP32 pipes and each reads its weights once per lane from shared memory,
// so shared-memory bandwidth and FMA throughput bind it well above that
// floor. The recurrence is serial in T: the block count (B / 16 = 128 at
// B = 2048, one per SM) is the parallelism.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;          // batch rows per block
constexpr int kRowsPerThread = 4;  // rows whose carries one thread holds
constexpr int kRowGroups = kRows / kRowsPerThread;
// one (row group, unit) per thread
constexpr int kMaxH = kThreads / kRowGroups;
constexpr int kXPerThread = 8;                // x_t elements staged per thread
constexpr int kMaxC = kThreads * kXPerThread / kRows;
constexpr int kWPad = 4;    // W row stride = 4H + kWPad elements

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

__host__ __device__ __forceinline__ size_t align16(size_t v) {
  return (v + 15) / 16 * 16;
}

// W_aug[:C+H] into shared memory, row k = [u][gate] (stride G + kWPad), and
// the bias row, f32 [u][gate]
template <typename T>
__device__ void stage_weights(const T* __restrict__ w_aug, T* ws, float* bias,
                              int K, int H) {
  const int G = 4 * H;
  const int Ws = G + kWPad;
  for (int e = threadIdx.x; e < K * G; e += kThreads) {
    const int k = e / G, j = e % G;
    ws[k * Ws + (j % H) * 4 + j / H] = w_aug[e];
  }
  for (int j = threadIdx.x; j < G; j += kThreads) {
    bias[(j % H) * 4 + j / H] = to_f32(w_aug[(size_t)K * G + j]);
  }
}

template <typename T>
size_t fwd_smem_bytes(int C, int H) {
  const size_t K = C + H;
  return align16(K * (4 * H + kWPad) * sizeof(T))  // W_aug[:C+H]
         + align16(2 * K * kRows * sizeof(T))     // [x_t ; h_{t-1}] x 2
         + 4 * H * sizeof(float);                 // bias row
}

template <typename T, bool kCs>
__global__ void __launch_bounds__(kThreads)
    lstm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w_aug,
                    T* __restrict__ hs, T* __restrict__ cs, int n_steps,
                    int B, int C, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = C + H;
  const int Ws = 4 * H + kWPad;
  T* ws = reinterpret_cast<T*>(smem);
  T* xh = reinterpret_cast<T*>(smem + align16((size_t)K * Ws * sizeof(T)));
  float* bias = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(xh) +
      align16((size_t)2 * K * kRows * sizeof(T)));

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kRows;
  stage_weights(w_aug, ws, bias, K, H);

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
        const float4 w = load4(ws + k * Ws + u * 4);
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
      T* hs_t = hs + (size_t)t * B * H;
      T* cs_t = kCs ? cs + (size_t)t * B * H : nullptr;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float ig = sigmoid(acc[i][0]);
        const float fg = sigmoid(acc[i][1]);
        const float gg = tanhf(acc[i][2]);
        const float og = sigmoid(acc[i][3]);
        c[i] = fg * c[i] + ig * gg;
        h[i] = og * tanhf(c[i]);
        const T h_op = from_f32<T>(h[i]);
        nxt[(C + u) * kRows + r0 + i] = h_op;
        const int row = b0 + r0 + i;
        if (row < B) {
          hs_t[(size_t)row * H + u] = h_op;
          if (kCs) cs_t[(size_t)row * H + u] = from_f32<T>(c[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kXPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < n_x) nxt[(e % C) * kRows + e / C] = xr[i];
    }
    __syncthreads();
  }
}

int n_blocks(int B) { return (B + kRows - 1) / kRows; }

template <typename T>
int launch_fwd(const void* x, const void* w_aug, void* hs, void* cs,
               int n_steps, int B, int C, int H, void* stream) {
  if (n_steps < 0 || B < 1 || C < 1 || H < 1 || C > kMaxC || H > kMaxH) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = fwd_smem_bytes<T>(C, H);
  auto kernel = cs != nullptr ? lstm_fwd_kernel<T, true>
                              : lstm_fwd_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_blocks(B), kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_aug),
      static_cast<T*>(hs), static_cast<T*>(cs), n_steps, B, C, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launcher returns the cudaError_t of its launches (0 = launched).
// cs may be null: the forward then writes hs only (_fwd_kernel_nocs).
int lstm_fwd_f32(const void* x, const void* w_aug, void* hs, void* cs,
                 int n_steps, int B, int C, int H, void* stream) {
  return launch_fwd<float>(x, w_aug, hs, cs, n_steps, B, C, H, stream);
}

int lstm_train_max_c(void) { return kMaxC; }
int lstm_train_max_h(void) { return kMaxH; }

const char* lstm_train_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
