// LSTM forward (K2) and backward (K3) for training on Hopper (sm_90a).
//
// Replaces the TPU kernels of remora_tpu/kernels/pallas_lstm.py:
//   * K2, lstm_fwd: _fwd_kernel / _fwd_kernel_nocs (launched by _fwd_call),
//     the full forward of a single-layer LSTM over x (T, B, C), writing every
//     hidden state hs (T, B, H) and, for the backward, every cell state cs;
//   * K3, lstm_bwd: _bwd_kernel (launched by _bwd_call), the reverse-time
//     backward that recomputes the gates from the saved h and c, writes dx
//     and accumulates dW_aug = sum_t [x_t; h_{t-1}; 1]^T . dgates.
//
//   gates_t = [x_t ; h_{t-1}] @ W_aug[:C+H] + W_aug[C+H]     (B, 4H), i|f|g|o
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
//   h_t = sigmoid(o) * tanh(c_t)
//
// Design (both kernels):
//   * one launch walks all T steps; each block owns kRows = 16 batch rows
//     and stages W_aug[:C+H] in dynamic shared memory once, interleaved by
//     hidden unit (row k holds [u][gate]) so a thread reads its unit's four
//     gate weights with one vector load. The row stride is padded by four
//     elements so a warp whose lanes walk k (the backward's transposed
//     product) reads conflict-free;
//   * the matmul operand [x_t ; h_{t-1}] lives in shared memory, k-major,
//     double-buffered; the next step's operand is loaded from global memory
//     into registers before the step's arithmetic and stored after it;
//   * f32: full-f32 FMAs (the Pallas kernels pin Precision.HIGHEST). bf16:
//     bf16 operands, f32 products and sums, h rounded into bf16 each step,
//     c/h (forward) and dh/dc (backward) carried in f32; the saved hs/cs and
//     the dgates are in bf16 -- the Pallas kernels' numerics.
//
// K2 is the inference kernel lstm_last.cu with per-step stores: thread
// (row group, unit) keeps its 4 rows' c and h in f32 registers and writes
// hs[t] (and cs[t] when kCs) in x's dtype, coalesced along the unit.
//
// K3, per step t = T-1 ... 0 (two block barriers per step):
//   A. recompute z = [x_t; h_{t-1}] @ W + b exactly as K2 did (h_{-1} = 0);
//   B. thread (row group, unit): gate math of _bwd_kernel with the dh and dc
//      carries in f32; dgates are rounded into the compute dtype and stored
//      in shared memory; the bias row of dW (the sum of dgates) is kept in
//      registers;
//   C. d[x;h] = dgates @ W^T reading the staged W transposed (lanes walk k):
//      dx[t] goes to global memory, dh_{t-1} stays in shared memory;
//   D. dW += [x;h]^T . dgates into a register tile of 8 k x 16 gates per
//      thread (128 f32 accumulators), so the (C+H) x 4H partial never leaves
//      the block until the end. Each block writes its partial, bias row
//      included, to an (n_blocks, C+H+1, 4H) f32 scratch and lstm_dw_reduce
//      sums the partials in block order: no float atomics, and results
//      repeat from run to run.
//
// Bounds at the main-path shape (T=124, B=2048, C=H=64) on an H100 SXM
// (67 TFLOP/s FP32, 989 TFLOP/s bf16 tensor cores, 3.35 TB/s):
//   K2 with cs: 2*T*B*(C+H)*4H = 16.64 GFLOP; x + hs + cs = 195 MB f32 /
//     97.5 MB bf16 -> >= 0.248 ms f32 (operations), >= 0.029 ms bf16 (bytes).
//   K3: ~3 x 16.7 = 50.1 GFLOP (recompute, dxh, dW); x, hs, cs, dhs read,
//     dx written, partials: ~342 MB f32 / 180 MB bf16 -> >= 0.75 ms f32
//     (operations), >= 0.054 ms bf16 (bytes).
// Both run on the FP32 pipes (no tensor cores) and every product reads one
// operand from shared memory, so shared-memory bandwidth and FMA throughput
// bound them well above those floors; wgmma and TMA staging are later work.
// The recurrence is serial in T: the block count (B / 16 = 128 at B = 2048,
// one per SM) is the parallelism.

#include <cuda_bf16.h>
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
// h_{t-1} elements staged per thread
constexpr int kHPerThread = kMaxH * kRows / kThreads;
constexpr int kWPad = 4;    // W row stride = 4H + kWPad elements
constexpr int kTileK = 8;   // dW register tile: kTileK x kTileG per thread
constexpr int kTileG = 16;
constexpr int kDxRows = kRows * 128 / kThreads;  // rows per thread in phase C

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// four consecutive operands (16-byte aligned f32, 8-byte aligned bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, __nv_bfloat16 a,
                                       __nv_bfloat16 b, __nv_bfloat16 c,
                                       __nv_bfloat16 d) {
  __nv_bfloat162 lo, hi;
  lo.x = a;
  lo.y = b;
  hi.x = c;
  hi.y = d;
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
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

// ----------------------------- K2: forward -----------------------------

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

// ----------------------------- K3: backward -----------------------------

struct BwdLayout {
  int K, Kp, G, Gp, Ws;
  size_t ws, xh, dg, dhc, bias, bsum, total;
};

template <typename T>
__host__ __device__ BwdLayout bwd_layout(int C, int H) {
  BwdLayout L;
  L.K = C + H;
  L.Kp = round_up(L.K, kTileK);
  L.G = 4 * H;
  L.Gp = round_up(L.G, kTileG);
  L.Ws = L.G + kWPad;
  // ws [K][Ws] T, xh [2][Kp][kRows] T, dg [kRows][Gp] T, dhc [kRows][H] f32,
  // bias [H][4] f32, bsum [kRowGroups][G] f32
  L.ws = 0;
  L.xh = L.ws + align16((size_t)L.K * L.Ws * sizeof(T));
  L.dg = L.xh + align16((size_t)2 * L.Kp * kRows * sizeof(T));
  L.dhc = L.dg + align16((size_t)kRows * L.Gp * sizeof(T));
  L.bias = L.dhc + align16((size_t)kRows * H * sizeof(float));
  L.bsum = L.bias + align16((size_t)L.G * sizeof(float));
  L.total = L.bsum + align16((size_t)kRowGroups * L.G * sizeof(float));
  return L;
}

// the dW register tiles must cover (C+H) x 4H with one tile per thread
__host__ __device__ inline bool bwd_fits(int C, int H) {
  const int tiles = round_up(C + H, kTileK) / kTileK *
                    (round_up(4 * H, kTileG) / kTileG);
  return tiles <= kThreads && C <= kMaxC && H <= kMaxH;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w_aug,
                    const T* __restrict__ hs, const T* __restrict__ cs,
                    const T* __restrict__ dhs, T* __restrict__ dx,
                    float* __restrict__ partials, int n_steps, int B, int C,
                    int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout L = bwd_layout<T>(C, H);
  const int K = L.K, G = L.G, Gp = L.Gp, Ws = L.Ws;
  T* ws = reinterpret_cast<T*>(smem + L.ws);
  T* xh = reinterpret_cast<T*>(smem + L.xh);
  T* dg = reinterpret_cast<T*>(smem + L.dg);
  float* dhc = reinterpret_cast<float*>(smem + L.dhc);
  float* bias = reinterpret_cast<float*>(smem + L.bias);
  float* bsum = reinterpret_cast<float*>(smem + L.bsum);

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kRows;
  stage_weights(w_aug, ws, bias, K, H);
  // zero the operand buffers (their k padding stays 0), dgates (its gate
  // padding stays 0) and the dh carry
  for (int e = tid; e < 2 * L.Kp * kRows; e += kThreads) {
    xh[e] = from_f32<T>(0.f);
  }
  for (int e = tid; e < kRows * Gp; e += kThreads) dg[e] = from_f32<T>(0.f);
  for (int e = tid; e < kRows * H; e += kThreads) dhc[e] = 0.f;
  __syncthreads();

  const int n_rows = min(kRows, B - b0);
  const int n_x = kRows * C;
  const int n_xvalid = n_rows * C;
  const int n_h = kRows * H;
  const int n_hvalid = n_rows * H;
  const size_t x_step = (size_t)B * C;
  const size_t h_step = (size_t)B * H;
  const T* x_tile = x + (size_t)b0 * C;
  const T* hs_tile = hs + (size_t)b0 * H;

  // [x_t ; h_{t-1}] of step t into operand buffer `buf` (from registers)
  auto load_x = [&](int t, T* xr) {
#pragma unroll
    for (int i = 0; i < kXPerThread; ++i) {
      const int e = tid + i * kThreads;
      xr[i] = (t >= 0 && e < n_xvalid) ? x_tile[(size_t)t * x_step + e]
                                       : from_f32<T>(0.f);
    }
  };
  auto load_h = [&](int t, T* hr) {  // h_{t-1}, zero for t = 0
#pragma unroll
    for (int i = 0; i < kHPerThread; ++i) {
      const int e = tid + i * kThreads;
      hr[i] = (t >= 1 && e < n_hvalid)
                  ? hs_tile[(size_t)(t - 1) * h_step + e]
                  : from_f32<T>(0.f);
    }
  };
  auto store_xh = [&](T* buf, const T* xr, const T* hr) {
#pragma unroll
    for (int i = 0; i < kXPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < n_x) buf[(e % C) * kRows + e / C] = xr[i];
    }
#pragma unroll
    for (int i = 0; i < kHPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < n_h) buf[(C + e % H) * kRows + e / H] = hr[i];
    }
  };

  // phase A/B mapping: thread (row group, unit)
  const bool active = tid < kRowGroups * H;
  const int u = tid % H;
  const int rg = tid / H;
  const int r0 = rg * kRowsPerThread;
  float4 b4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (active) {
    b4 = make_float4(bias[4 * u], bias[4 * u + 1], bias[4 * u + 2],
                     bias[4 * u + 3]);
  }
  float dcc[kRowsPerThread];     // dc carry
  float c_cur[kRowsPerThread];   // c_t (f32 of the saved compute dtype)
  float bacc[4] = {0.f, 0.f, 0.f, 0.f};  // bias row of dW, this thread's rows
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    dcc[i] = 0.f;
    const int row = b0 + r0 + i;
    c_cur[i] = (active && n_steps > 0 && row < B)
                   ? to_f32(cs[((size_t)(n_steps - 1) * B + row) * H + u])
                   : 0.f;
  }

  // phase D mapping: thread (k tile, gate tile)
  const int n_gt = Gp / kTileG;
  const int kt = tid / n_gt;
  const int gt = tid % n_gt;
  const bool dw_active = kt < L.Kp / kTileK;
  float acc[kTileK][kTileG];
#pragma unroll
  for (int a = 0; a < kTileK; ++a)
#pragma unroll
    for (int b = 0; b < kTileG; ++b) acc[a][b] = 0.f;

  if (n_steps > 0) {
    T xr[kXPerThread], hr[kHPerThread];
    load_x(n_steps - 1, xr);
    load_h(n_steps - 1, hr);
    store_xh(xh + ((n_steps - 1) & 1) * L.Kp * kRows, xr, hr);
  }
  __syncthreads();

  for (int t = n_steps - 1; t >= 0; --t) {
    const T* cur = xh + (t & 1) * L.Kp * kRows;
    T* nxt = xh + ((t + 1) & 1) * L.Kp * kRows;  // step t-1's buffer

    // step t-1's operand, and this step's per-row inputs, into registers
    T xr[kXPerThread], hr[kHPerThread];
    load_x(t - 1, xr);
    load_h(t - 1, hr);
    float c_prev[kRowsPerThread], dh_in[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = b0 + r0 + i;
      const bool ok = active && row < B;
      c_prev[i] = (ok && t > 0)
                      ? to_f32(cs[((size_t)(t - 1) * B + row) * H + u])
                      : 0.f;
      dh_in[i] = ok ? to_f32(dhs[((size_t)t * B + row) * H + u]) : 0.f;
    }

    if (active) {
      // A: z = [x_t ; h_{t-1}] @ W + b
      float z[kRowsPerThread][4];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        z[i][0] = b4.x;
        z[i][1] = b4.y;
        z[i][2] = b4.z;
        z[i][3] = b4.w;
      }
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float4 w = load4(ws + k * Ws + u * 4);
        const float4 v = load4(cur + k * kRows + r0);
        const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          z[i][0] = fmaf(xv[i], w.x, z[i][0]);
          z[i][1] = fmaf(xv[i], w.y, z[i][1]);
          z[i][2] = fmaf(xv[i], w.z, z[i][2]);
          z[i][3] = fmaf(xv[i], w.w, z[i][3]);
        }
      }
      // B: gate cotangents (_bwd_kernel's math)
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = r0 + i;
        const bool ok = b0 + r < B;
        const float ig = sigmoid(z[i][0]);
        const float fg = sigmoid(z[i][1]);
        const float gg = tanhf(z[i][2]);
        const float og = sigmoid(z[i][3]);
        const float tanh_c = tanhf(c_cur[i]);
        const float dh = dh_in[i] + dhc[r * H + u];
        const float d_o = dh * tanh_c;
        const float dc = dcc[i] + dh * og * (1.f - tanh_c * tanh_c);
        const T dgi = from_f32<T>(ok ? dc * gg * ig * (1.f - ig) : 0.f);
        const T dgf = from_f32<T>(ok ? dc * c_prev[i] * fg * (1.f - fg) : 0.f);
        const T dgg = from_f32<T>(ok ? dc * ig * (1.f - gg * gg) : 0.f);
        const T dgo = from_f32<T>(ok ? d_o * og * (1.f - og) : 0.f);
        store4(dg + r * Gp + u * 4, dgi, dgf, dgg, dgo);
        bacc[0] += to_f32(dgi);
        bacc[1] += to_f32(dgf);
        bacc[2] += to_f32(dgg);
        bacc[3] += to_f32(dgo);
        dcc[i] = ok ? dc * fg : 0.f;
        c_cur[i] = c_prev[i];
      }
    }
    __syncthreads();  // dgates complete; dh carry read

    store_xh(nxt, xr, hr);  // step t-1's operand (its buffer is idle now)

    // C: d[x;h] = dgates @ W^T; lanes walk k, each thread kDxRows rows
    for (int item = tid; item < K * (kRows / kDxRows); item += kThreads) {
      const int k = item % K;
      const int rs = (item / K) * kDxRows;
      float d[kDxRows];
#pragma unroll
      for (int r = 0; r < kDxRows; ++r) d[r] = 0.f;
      const T* wrow = ws + k * Ws;
      for (int p = 0; p < G; p += 4) {
        const float4 w = load4(wrow + p);
#pragma unroll
        for (int r = 0; r < kDxRows; ++r) {
          const float4 g = load4(dg + (rs + r) * Gp + p);
          d[r] = fmaf(w.x, g.x, d[r]);
          d[r] = fmaf(w.y, g.y, d[r]);
          d[r] = fmaf(w.z, g.z, d[r]);
          d[r] = fmaf(w.w, g.w, d[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kDxRows; ++r) {
        const int row = b0 + rs + r;
        if (k < C) {
          if (row < B) dx[((size_t)t * B + row) * C + k] = from_f32<T>(d[r]);
        } else {
          dhc[(rs + r) * H + (k - C)] = d[r];
        }
      }
    }

    // D: dW[k][gate] += sum_rows [x;h][row][k] * dgates[row][gate]
    if (dw_active) {
      const T* xk = cur + kt * kTileK * kRows;
      const T* gj = dg + gt * kTileG;
#pragma unroll 2
      for (int r = 0; r < kRows; ++r) {
        float xv[kTileK], gv[kTileG];
#pragma unroll
        for (int a = 0; a < kTileK; ++a) xv[a] = to_f32(xk[a * kRows + r]);
#pragma unroll
        for (int b = 0; b < kTileG; b += 4) {
          const float4 g = load4(gj + r * Gp + b);
          gv[b] = g.x;
          gv[b + 1] = g.y;
          gv[b + 2] = g.z;
          gv[b + 3] = g.w;
        }
#pragma unroll
        for (int a = 0; a < kTileK; ++a)
#pragma unroll
          for (int b = 0; b < kTileG; ++b)
            acc[a][b] = fmaf(xv[a], gv[b], acc[a][b]);
      }
    }
    __syncthreads();  // dh carry and step t-1's operand written
  }

  // this block's partial dW_aug (rows 0..K-1 from the tiles, row K = bias)
  float* part = partials + (size_t)blockIdx.x * (K + 1) * G;
  if (dw_active) {
#pragma unroll
    for (int a = 0; a < kTileK; ++a) {
      const int k = kt * kTileK + a;
#pragma unroll
      for (int b = 0; b < kTileG; ++b) {
        const int p = gt * kTileG + b;  // interleaved [u][gate] index
        if (k < K && p < G) {
          part[(size_t)k * G + (p % 4) * H + p / 4] = acc[a][b];
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int g = 0; g < 4; ++g) bsum[rg * G + g * H + u] = bacc[g];
  }
  __syncthreads();
  for (int j = tid; j < G; j += kThreads) {
    float s = 0.f;
    for (int q = 0; q < kRowGroups; ++q) s += bsum[q * G + j];
    part[(size_t)K * G + j] = s;
  }
}

// dW = sum over blocks of the partials, in block order
__global__ void lstm_dw_reduce(const float* __restrict__ partials,
                               float* __restrict__ dw, int n_blocks,
                               int n_elems) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elems) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partials[(size_t)b * n_elems + e];
  dw[e] = s;
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

template <typename T>
int launch_bwd(const void* x, const void* w_aug, const void* hs,
               const void* cs, const void* dhs, void* dx, void* partials,
               void* dw, int n_steps, int B, int C, int H, void* stream) {
  if (n_steps < 0 || B < 1 || C < 1 || H < 1 || !bwd_fits(C, H)) {
    return (int)cudaErrorInvalidValue;
  }
  const BwdLayout L = bwd_layout<T>(C, H);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const int blocks = n_blocks(B);
  lstm_bwd_kernel<T><<<blocks, kThreads, L.total, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_aug),
      static_cast<const T*>(hs), static_cast<const T*>(cs),
      static_cast<const T*>(dhs), static_cast<T*>(dx),
      static_cast<float*>(partials), n_steps, B, C, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_elems = (C + H + 1) * 4 * H;
  lstm_dw_reduce<<<(n_elems + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(partials), static_cast<float*>(dw), blocks,
      n_elems);
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

int lstm_fwd_bf16(const void* x, const void* w_aug, void* hs, void* cs,
                  int n_steps, int B, int C, int H, void* stream) {
  return launch_fwd<__nv_bfloat16>(x, w_aug, hs, cs, n_steps, B, C, H,
                                   stream);
}

// partials: (lstm_train_blocks(B), C+H+1, 4H) f32 scratch; dw: (C+H+1, 4H) f32
int lstm_bwd_f32(const void* x, const void* w_aug, const void* hs,
                 const void* cs, const void* dhs, void* dx, void* partials,
                 void* dw, int n_steps, int B, int C, int H, void* stream) {
  return launch_bwd<float>(x, w_aug, hs, cs, dhs, dx, partials, dw, n_steps,
                           B, C, H, stream);
}

int lstm_bwd_bf16(const void* x, const void* w_aug, const void* hs,
                  const void* cs, const void* dhs, void* dx, void* partials,
                  void* dw, int n_steps, int B, int C, int H, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, w_aug, hs, cs, dhs, dx, partials, dw,
                                   n_steps, B, C, H, stream);
}

int lstm_train_blocks(int B) { return n_blocks(B); }
int lstm_train_max_c(void) { return kMaxC; }
int lstm_train_max_h(void) { return kMaxH; }
int lstm_bwd_fits(int C, int H) { return bwd_fits(C, H) ? 1 : 0; }

const char* lstm_train_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
