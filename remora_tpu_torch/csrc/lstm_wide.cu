// The LSTM forward legs at the widths the main-shape kernels do not take,
// sm_90a: K1 (last-only forward) and K2 (forward with hs and cs) for every
// 1 <= C <= 128, 1 <= H <= 128, in f32 and bf16. K3, the backward, at those
// widths is lstm_wide_bwd.cu.
//
// Replaces, at those widths, remora_tpu/kernels/pallas_lstm.py::
// _fwd_kernel_last (K1) and _fwd_kernel / _fwd_kernel_nocs (K2), which the
// JAX package runs at any width (_tile_plan shrinks its batch tile for wider
// layers). The main-shape kernels (lstm_last.cu, lstm_train.cu,
// lstm_fwd_mma.cu) keep every shape they take; kernels/lstm.py routes only
// the shapes they refuse here (ConvLSTM_w_ref at size 65 .. 128).
//
// Why another kernel: at C = H = 128, W_aug is (C + H + 1) x 4H = 257 x
// 512, 526 KB in f32 and 263 KB in bf16, above the 227 KB of shared memory
// a block can use, and too many fragments for the registers of one block.
// This design keeps W in device memory and reads it through the L1/L2
// caches (__ldg) on every step; a block carries h (and the step's
// operands) in shared memory. It is the simple design: a cluster of 2-4
// CTAs, each holding a slice of W's gate columns in shared memory and
// swapping h_t through distributed shared memory (as lstm_wide_bwd.cu's
// recurrence swaps its dh partials), is the later redesign.
//
//   wide_fwd_kernel (K1, K2): a block owns 16 batch rows and walks all T
//     steps. Thread (row group, unit u) keeps rows r0 .. r0+7 of unit u:
//     its 4 gates x 8 rows in 32 f32 accumulators, c and h carried in f32;
//     its four gate weights of a k are one load (W interleaved by unit by
//     the wrapper, [k][u][gate]), the next kPreK rows' loads in flight
//     while a group of rows sums.
//     Each step sums gates = [x_t ; h_{t-1}] . W_aug[:C+H] over k ascending
//     (x then h, one accumulator, as the JAX kernel's one dot), then adds
//     the bias row. The operand [x_t ; h_{t-1}] is k-major in shared memory,
//     double-buffered, f32 (bf16 values widened exactly); x_{t+1} is loaded
//     into registers before the step's sums and stored after, so a step has
//     one barrier. bf16 rounds the h operand every step (hs is that h).
//
// Numerics are the plain twins' (kernels/lstm.py): f32 sums of products of
// the dtype's values; bf16 rounds h every step.
//
// Bound at C = H = 128, T = 124, B = 2048 (H100 SXM: 67 TFLOP/s FP32, 989
// bf16, 3.35 TB/s): the forward is 66.6 GFLOP (f32: 0.99 ms, operations).
// The design moves more: each block reads all of W from L2 every step (128
// blocks x 526 KB x 124 steps in f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kMaxC = 128;
constexpr int kMaxH = 128;
constexpr int kMaxK = kMaxC + kMaxH;
constexpr int kThreads = 256;
constexpr int kRows = 16;            // batch rows a block in the walks
constexpr int kRowsPerThread = 8;    // rows of one (row group, unit) thread
constexpr int kXRegs = kRows * kMaxC / kThreads;  // x_{t+1} a thread
constexpr int kPreK = 8;             // W rows in flight a thread (forward)

static_assert(kThreads == kMaxH * (kRows / kRowsPerThread),
              "one thread per (row group, unit)");

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16_bits v) {
  return __uint_as_float((uint32_t)v << 16);
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const bf16_bits* p) {
  return widen(__ldg(p));
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16_bits narrow<bf16_bits>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// v rounded to T and widened back: the operand value the plain twins use
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return widen(narrow<T>(v));
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

// ---------------- K1 / K2: the forward walk ----------------

// unit u's four gate weights of row k of W_aug interleaved as [k][u][gate]
__device__ __forceinline__ void load_gates(const float* w_il, int k, int u,
                                           int H, float* wv) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(w_il) +
                         (size_t)k * H + u);
  wv[0] = v.x;
  wv[1] = v.y;
  wv[2] = v.z;
  wv[3] = v.w;
}
__device__ __forceinline__ void load_gates(const bf16_bits* w_il, int k,
                                           int u, int H, float* wv) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(w_il) +
                        (size_t)k * H + u);
  wv[0] = __uint_as_float(v.x << 16);
  wv[1] = __uint_as_float(v.x & 0xffff0000u);
  wv[2] = __uint_as_float(v.y << 16);
  wv[3] = __uint_as_float(v.y & 0xffff0000u);
}

template <typename T, bool kSeq, bool kCs>
__global__ void __launch_bounds__(kThreads)
    wide_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ w_il, T* __restrict__ hs,
                    T* __restrict__ cs, int n_steps, int B, int C, int H) {
  __shared__ __align__(16) float xh[2][kMaxK][kRows];
  const int K = C + H, G = 4 * H;
  const int tid = threadIdx.x;
  const int u = tid % kMaxH;
  const int r0 = (tid / kMaxH) * kRowsPerThread;
  const bool active = u < H;
  const int b0 = blockIdx.x * kRows;
  const int n_valid = min(kRows, B - b0) * C;  // x elements of real rows
  const int n_x = kRows * C;
  const T* x_tile = x + (size_t)b0 * C;
  const size_t x_step = (size_t)B * C;

  for (int e = tid; e < n_x; e += kThreads) {
    xh[0][e % C][e / C] =
        (n_steps > 0 && e < n_valid) ? load(x_tile + e) : 0.f;
  }
  for (int e = tid; e < H * kRows; e += kThreads) {
    xh[0][C + e / kRows][e % kRows] = 0.f;  // h_{-1} = 0
  }
  float bias[4] = {0.f, 0.f, 0.f, 0.f};
  if (active) {
#pragma unroll
    for (int g = 0; g < 4; ++g) bias[g] = load(w + (size_t)K * G + g * H + u);
  }
  float c[kRowsPerThread], h[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) c[i] = h[i] = 0.f;
  __syncthreads();

  for (int t = 0; t < n_steps; ++t) {
    const float(*cur)[kRows] = xh[t & 1];
    float(*nxt)[kRows] = xh[(t + 1) & 1];
    const bool more = t + 1 < n_steps;
    T xr[kXRegs];
#pragma unroll
    for (int i = 0; i < kXRegs; ++i) {
      const int e = tid + i * kThreads;
      xr[i] = (more && e < n_valid) ? x_tile[(size_t)(t + 1) * x_step + e]
                                    : T(0);
    }
    if (active) {
      float acc[kRowsPerThread][4];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[i][g] = 0.f;
      // W's rows come from L2: the next kPreK rows' loads are in flight
      // while this group's sums run
      float wcur[kPreK][4];
#pragma unroll
      for (int j = 0; j < kPreK; ++j) load_gates(w_il, j < K ? j : 0, u, H,
                                                 wcur[j]);
      for (int k0 = 0; k0 < K; k0 += kPreK) {
        float wnext[kPreK][4];
#pragma unroll
        for (int j = 0; j < kPreK; ++j) {
          const int k = k0 + kPreK + j;
          load_gates(w_il, k < K ? k : 0, u, H, wnext[j]);
        }
#pragma unroll
        for (int j = 0; j < kPreK; ++j) {
          const int k = k0 + j;
          if (k < K) {
            const float4 a = *reinterpret_cast<const float4*>(&cur[k][r0]);
            const float4 b =
                *reinterpret_cast<const float4*>(&cur[k][r0 + 4]);
            const float v[kRowsPerThread] = {a.x, a.y, a.z, a.w,
                                             b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
              for (int g = 0; g < 4; ++g)
                acc[i][g] = fmaf(v[i], wcur[j][g], acc[i][g]);
          }
        }
#pragma unroll
        for (int j = 0; j < kPreK; ++j)
#pragma unroll
          for (int g = 0; g < 4; ++g) wcur[j][g] = wnext[j][g];
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float ig = sigmoid(acc[i][0] + bias[0]);
        const float fg = sigmoid(acc[i][1] + bias[1]);
        const float gg = tanhf(acc[i][2] + bias[2]);
        const float og = sigmoid(acc[i][3] + bias[3]);
        c[i] = fg * c[i] + ig * gg;
        h[i] = rounded<T>(og * tanhf(c[i]));
        nxt[C + u][r0 + i] = h[i];
        const int row = b0 + r0 + i;
        if (row < B) {
          const size_t o = ((size_t)t * B + row) * H + u;
          if (kSeq) hs[o] = narrow<T>(h[i]);
          if (kCs) cs[o] = narrow<T>(c[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kXRegs; ++i) {
      const int e = tid + i * kThreads;
      if (e < n_x) nxt[e % C][e / C] = widen(xr[i]);
    }
    __syncthreads();
  }
  if (!kSeq && active) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = b0 + r0 + i;
      if (row < B) hs[(size_t)row * H + u] = narrow<T>(h[i]);
    }
  }
}

bool fits(int C, int H) {
  return C >= 1 && C <= kMaxC && H >= 1 && H <= kMaxH;
}

template <typename T>
int launch_fwd(const void* x, const void* w_aug, const void* w_il, void* hs,
               void* cs, int n_steps, int B, int C, int H, bool seq,
               void* stream) {
  if (n_steps < 0 || B < 1 || !fits(C, H)) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kRows - 1) / kRows;
  const cudaStream_t s = (cudaStream_t)stream;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w_aug);
  const T* ip = static_cast<const T*>(w_il);
  T* hp = static_cast<T*>(hs);
  T* cp = static_cast<T*>(cs);
  if (!seq) {
    wide_fwd_kernel<T, false, false><<<blocks, kThreads, 0, s>>>(
        xp, wp, ip, hp, nullptr, n_steps, B, C, H);
  } else if (cs != nullptr) {
    wide_fwd_kernel<T, true, true><<<blocks, kThreads, 0, s>>>(
        xp, wp, ip, hp, cp, n_steps, B, C, H);
  } else {
    wide_fwd_kernel<T, true, false><<<blocks, kThreads, 0, s>>>(
        xp, wp, ip, hp, nullptr, n_steps, B, C, H);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launches (0 = launched). bf16 = 1
// takes bf16 tensors, 0 f32 ones. w_il is W_aug[:C+H] interleaved by unit,
// (C + H, H, 4): element [k][u][g] = W_aug[k][g * H + u]; the bias row is
// read from w_aug. K2: cs may be null (no cs written).
int lstm_wide_fwd(int bf16, const void* x, const void* w_aug,
                  const void* w_il, void* hs, void* cs, int n_steps, int B,
                  int C, int H, void* stream) {
  return bf16 ? launch_fwd<bf16_bits>(x, w_aug, w_il, hs, cs, n_steps, B, C,
                                      H, true, stream)
              : launch_fwd<float>(x, w_aug, w_il, hs, cs, n_steps, B, C, H,
                                  true, stream);
}

// K1: h_{T-1} (B, H) into out
int lstm_wide_last(int bf16, const void* x, const void* w_aug,
                   const void* w_il, void* out, int n_steps, int B, int C,
                   int H, void* stream) {
  return bf16 ? launch_fwd<bf16_bits>(x, w_aug, w_il, out, nullptr, n_steps,
                                      B, C, H, false, stream)
              : launch_fwd<float>(x, w_aug, w_il, out, nullptr, n_steps, B,
                                  C, H, false, stream);
}

const char* lstm_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
