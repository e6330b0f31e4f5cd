// The LSTM legs at the widths the main-shape kernels do not take, sm_90a:
// K1 (last-only forward), K2 (forward with hs and cs) and K3 (backward) for
// every 1 <= C <= 128, 1 <= H <= 128, in f32 and bf16.
//
// Replaces, at those widths, remora_tpu/kernels/pallas_lstm.py::
// _fwd_kernel_last (K1), _fwd_kernel / _fwd_kernel_nocs (K2) and
// _bwd_kernel (K3), which the JAX package runs at any width
// (_tile_plan shrinks its batch tile for wider layers). The main-shape
// kernels (lstm_last.cu, lstm_train.cu, lstm_fwd_mma.cu, lstm_bwd_f32.cu,
// lstm_bwd_mma.cu) keep every shape they take; kernels/lstm.py routes only
// the shapes they refuse here (ConvLSTM_w_ref at size 65 .. 128).
//
// Why another kernel: at C = H = 128, W_aug is (C + H + 1) x 4H = 257 x
// 512, 526 KB in f32 and 263 KB in bf16, above the 227 KB of shared memory
// a block can use, and too many fragments for the registers of one block.
// This design keeps W in device memory and reads it through the L1/L2
// caches (__ldg) on every step; a block carries h (and the step's
// operands) in shared memory. It is the simple design: a cluster of 2-4
// CTAs, each holding a slice of W's gate columns in shared memory and
// swapping h_t through distributed shared memory, is the later redesign.
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
//   K3 in three parts, as lstm_bwd_mma.cu does for bf16 at the main shape:
//     (a) wide_gemm_{f32,bf16}_kernel<kGates>: Z = [x_t ; h_{t-1}] .
//         W_aug[:C+H] + b for every (t, row) at once, f32 out;
//     (b) wide_rec_kernel, the only serial part: one block per 16 batch
//         rows walks t = T-1 .. 0; thread (row group, unit) does the gate
//         math of its 8 rows (dgates rounded to the dtype once) and then
//         its 8 rows of dh_{t-1} = dgates_t . W_h^T over 4H ascending, W_h^T
//         a (4H, H) copy so the unit's column reads coalesce; dgates go to
//         device memory and to a double-buffered shared tile, one barrier a
//         step;
//     (c) wide_gemm_*_kernel<kDx>: dx = dgates . W_x^T, rounded once;
//         wide_gemm_*_kernel<kDw>: dW_aug = [x ; h_{t-1} ; 1]^T . dgates over
//         fixed chunks of kDwChunkRows rows into f32 partials, which
//         ordered_sum (mma_sm90.cuh) sums in chunk order: no atomics, and a
//         repeated call gives the same bits.
//   The products are written by hand: f32 as 8 x 4 FFMA register tiles a
//   thread (block tile 128 x 64, k ascending in a thread), bf16 on the
//   tensor cores (mma.sync.m16n8k16, f32 accumulators, ldmatrix from
//   padded shared tiles; block tile 128 x 64, 8 warps of 32 x 32); the
//   next depth stage's operands are loaded into registers while a stage
//   computes.
//
// Numerics are the plain twins' (kernels/lstm.py): f32 sums of products of
// the dtype's values; bf16 rounds h every step, dgates once before every
// product and dx once; dh and dc carried in f32; dW in f32.
//
// Bound at C = H = 128, T = 124, B = 2048 (H100 SXM: 67 TFLOP/s FP32, 989
// bf16, 3.35 TB/s): the forward is 66.6 GFLOP (f32: 0.99 ms, operations),
// the backward three times that. The design moves more: each forward block
// reads all of W from L2 every step (128 blocks x 526 KB x 124 steps in
// f32), and K3's parts write Z and dgates through device memory. What
// holds the recurrence at ~36 us a step (an H100 at 700 W, chip_smoke.py
// phase 3d's parts) is not known: neither keeping 16 of W_h^T's rows in
// flight nor halving the shared dgates reads an FMA (4 rows x 2 units a
// thread) moved it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kMaxC = 128;
constexpr int kMaxH = 128;
constexpr int kMaxK = kMaxC + kMaxH;
constexpr int kMaxG = 4 * kMaxH;
constexpr int kThreads = 256;
constexpr int kRows = 16;            // batch rows a block in the walks
constexpr int kRowsPerThread = 8;    // rows of one (row group, unit) thread
constexpr int kXRegs = kRows * kMaxC / kThreads;  // x_{t+1} a thread
constexpr int kPreK = 8;             // W rows in flight a thread (forward)
constexpr int kBM = 128;             // product tile rows
constexpr int kBN = 64;              // product tile columns
constexpr int kBKF = 16;             // f32 product depth a stage
constexpr int kBKH = 16;             // bf16 product depth a stage
constexpr int kPadH = 8;             // bf16 tile row padding (ldmatrix)
constexpr int kDwChunkRows = 2048;   // dW's K rows a chunk
constexpr int kRecSmem = 2 * kMaxG * kRows * (int)sizeof(float);
constexpr bf16_bits kOne = 0x3F80;   // bf16 1.0

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

template <typename T>
__device__ __forceinline__ T one();
template <>
__device__ __forceinline__ float one<float>() {
  return 1.0f;
}
template <>
__device__ __forceinline__ bf16_bits one<bf16_bits>() {
  return kOne;
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

// ---------------- K3 (b): the reverse recurrence ----------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    wide_rec_kernel(const float* __restrict__ z, const T* __restrict__ cs,
                    const T* __restrict__ dhs, const T* __restrict__ w_ht,
                    T* __restrict__ dg, int n_steps, int B, int H) {
  extern __shared__ __align__(16) float dgs[];  // [2][4H][kRows]
  const int G = 4 * H;
  const int tid = threadIdx.x;
  const int u = tid % kMaxH;
  const int r0 = (tid / kMaxH) * kRowsPerThread;
  const bool active = u < H;
  const int b0 = blockIdx.x * kRows;
  float dh_c[kRowsPerThread], dc_c[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) dh_c[i] = dc_c[i] = 0.f;

  for (int t = n_steps - 1; t >= 0; --t) {
    float* buf = dgs + (t & 1) * kMaxG * kRows;
    if (active) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int row = b0 + r0 + i;
        float q0 = 0.f, q1 = 0.f, q2 = 0.f, q3 = 0.f;
        if (row < B) {
          const size_t m = (size_t)t * B + row;
          const float* zm = z + m * G + u;
          const float ig = sigmoid(__ldg(zm));
          const float fg = sigmoid(__ldg(zm + H));
          const float gg = tanhf(__ldg(zm + 2 * H));
          const float og = sigmoid(__ldg(zm + 3 * H));
          const float c_prev =
              t > 0 ? load(cs + (m - B) * H + u) : 0.f;
          const float tanh_c = tanhf(load(cs + m * H + u));
          const float dh = load(dhs + m * H + u) + dh_c[i];
          const float dc =
              dc_c[i] + dh * og * (1.0f - tanh_c * tanh_c);
          q0 = rounded<T>(dc * gg * ig * (1.0f - ig));
          q1 = rounded<T>(dc * c_prev * fg * (1.0f - fg));
          q2 = rounded<T>(dc * ig * (1.0f - gg * gg));
          q3 = rounded<T>(dh * tanh_c * og * (1.0f - og));
          dc_c[i] = dc * fg;
          T* dgm = dg + m * G + u;
          dgm[0] = narrow<T>(q0);
          dgm[H] = narrow<T>(q1);
          dgm[2 * H] = narrow<T>(q2);
          dgm[3 * H] = narrow<T>(q3);
        }
        float* bi = buf + u * kRows + r0 + i;
        bi[0] = q0;
        bi[H * kRows] = q1;
        bi[2 * H * kRows] = q2;
        bi[3 * H * kRows] = q3;
      }
    }
    __syncthreads();
    if (active && t > 0) {
      float acc[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
      const T* wg = w_ht + u;
#pragma unroll 4
      for (int g = 0; g < G; ++g, wg += H) {
        const float wv = load(wg);
        const float4 a = *reinterpret_cast<const float4*>(buf + g * kRows + r0);
        const float4 b =
            *reinterpret_cast<const float4*>(buf + g * kRows + r0 + 4);
        const float v[kRowsPerThread] = {a.x, a.y, a.z, a.w,
                                         b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          acc[i] = fmaf(v[i], wv, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) dh_c[i] = acc[i];
    }
  }
}

// ---------------- K3 (a), (c): the products ----------------

enum Op { kGates, kDx, kDw };

template <typename T>
struct Prod {
  const T* x;
  const T* hs;
  const T* w;
  const T* dg;
  float* z;
  T* dx;
  float* partials;
  long long TB;  // T * B rows of x, hs and dgates
  int B, C, H;
};

// [x_m ; h_{m-B} (zero for m < B) ; 1] at column k
template <typename T>
__device__ __forceinline__ T xh1(const Prod<T>& p, long long m, int k) {
  if (k < p.C) return p.x[m * p.C + k];
  if (k < p.C + p.H) return m >= p.B ? p.hs[(m - p.B) * p.H + (k - p.C)] : T(0);
  return one<T>();
}

// the product's dimensions: M rows, N columns
template <Op op, typename T>
__device__ __forceinline__ long long prod_m(const Prod<T>& p) {
  return op == kDw ? p.C + p.H + 1 : p.TB;
}
template <Op op, typename T>
__device__ __forceinline__ int prod_n(const Prod<T>& p) {
  return op == kDx ? p.C : 4 * p.H;
}

// A (m, k) and B (k, n); out of range reads give zero
template <Op op, typename T>
__device__ __forceinline__ T prod_a(const Prod<T>& p, long long m,
                                    long long k, long long k_end) {
  if (m >= prod_m<op>(p) || k >= k_end) return T(0);
  if (op == kGates) return xh1(p, m, (int)k);
  if (op == kDx) return p.dg[m * 4 * p.H + k];
  return xh1(p, k, (int)m);  // kDw: [x ; h ; 1]^T
}
template <Op op, typename T>
__device__ __forceinline__ T prod_b(const Prod<T>& p, long long k, int n,
                                    long long k_end) {
  if (n >= prod_n<op>(p) || k >= k_end) return T(0);
  if (op == kGates) return p.w[k * 4 * p.H + n];
  if (op == kDx) return p.w[(long long)n * 4 * p.H + k];  // W_x^T
  return p.dg[k * 4 * p.H + n];
}

// whether consecutive threads should walk A's (B's) k index (else its m or
// n index) for coalesced reads of the source
template <Op op>
__host__ __device__ constexpr bool a_k_fast() {
  return op != kDw;
}
template <Op op>
__host__ __device__ constexpr bool b_k_fast() {
  return op == kDx;
}

template <Op op, typename T>
__device__ __forceinline__ void prod_out(const Prod<T>& p, long long m,
                                         int n, float v, int chunk) {
  if (m >= prod_m<op>(p) || n >= prod_n<op>(p)) return;
  const int G = 4 * p.H;
  if (op == kGates) {
    p.z[m * G + n] = v + widen(p.w[(long long)(p.C + p.H) * G + n]);
  } else if (op == kDx) {
    p.dx[m * p.C + n] = narrow<T>(v);
  } else {
    p.partials[((long long)chunk * (p.C + p.H + 1) + m) * G + n] = v;
  }
}

// this block's k range: all of K, or dW's chunk blockIdx.z
template <Op op, typename T>
__device__ __forceinline__ void prod_k(const Prod<T>& p, long long* k0,
                                       long long* k1) {
  if (op == kDw) {
    *k0 = (long long)blockIdx.z * kDwChunkRows;
    *k1 = min(p.TB, *k0 + kDwChunkRows);
  } else {
    *k0 = 0;
    *k1 = op == kGates ? p.C + p.H : 4 * p.H;
  }
}

// f32: thread (tm, tn) owns rows tm*8 .. +7 and columns tn*4 .. +3 of the
// 128 x 64 tile; A and B staged k-major, one stage of 16 k at a time
template <Op op>
__global__ void __launch_bounds__(kThreads)
    wide_gemm_f32_kernel(Prod<float> p) {
  __shared__ __align__(16) float as[kBKF][kBM + 4];
  __shared__ __align__(16) float bs[kBKF][kBN + 4];
  const int tid = threadIdx.x;
  const int tm = tid / 16, tn = tid % 16;
  const long long m0 = (long long)blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  long long k0, k1;
  prod_k<op>(p, &k0, &k1);
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // the next stage's operands are loaded into registers while this one
  // computes
  constexpr int kA = kBM * kBKF / kThreads, kB = kBN * kBKF / kThreads;
  float ra[kA], rb[kB];
  auto fetch = [&](long long kb) {
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int e = tid + i * kThreads;
      const int m = a_k_fast<op>() ? e / kBKF : e % kBM;
      const int k = a_k_fast<op>() ? e % kBKF : e / kBM;
      ra[i] = prod_a<op>(p, m0 + m, kb + k, k1);
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int e = tid + i * kThreads;
      const int n = b_k_fast<op>() ? e / kBKF : e % kBN;
      const int k = b_k_fast<op>() ? e % kBKF : e / kBN;
      rb[i] = prod_b<op>(p, kb + k, n0 + n, k1);
    }
  };
  fetch(k0);
  for (long long kb = k0; kb < k1; kb += kBKF) {
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int e = tid + i * kThreads;
      as[a_k_fast<op>() ? e % kBKF : e / kBM]
        [a_k_fast<op>() ? e / kBKF : e % kBM] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int e = tid + i * kThreads;
      bs[b_k_fast<op>() ? e % kBKF : e / kBN]
        [b_k_fast<op>() ? e / kBKF : e % kBN] = rb[i];
    }
    __syncthreads();
    if (kb + kBKF < k1) fetch(kb + kBKF);
#pragma unroll
    for (int k = 0; k < kBKF; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[k][tm * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[k][tm * 8 + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[k][tn * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      prod_out<op>(p, m0 + tm * 8 + i, n0 + tn * 4 + j, acc[i][j],
                   blockIdx.z);
}

// bf16: warp (wm, wn) owns rows wm*32 .. +31 and columns wn*32 .. +31 of
// the 128 x 64 tile as 2 x 4 mma.sync tiles; A staged [m][k] and B [n][k]
// (k contiguous, rows padded by 8 so ldmatrix's 8 rows hit 8 bank groups)
template <Op op>
__global__ void __launch_bounds__(kThreads)
    wide_gemm_bf16_kernel(Prod<bf16_bits> p) {
  __shared__ __align__(16) bf16_bits as[kBM][kBKH + kPadH];
  __shared__ __align__(16) bf16_bits bs[kBN][kBKH + kPadH];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;
  const long long m0 = (long long)blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  long long k0, k1;
  prod_k<op>(p, &k0, &k1);
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  // the next stage's operands are loaded into registers while this one
  // computes
  constexpr int kA = kBM * kBKH / kThreads, kB = kBN * kBKH / kThreads;
  bf16_bits ra[kA], rb[kB];
  auto fetch = [&](long long kb) {
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int e = tid + i * kThreads;
      const int m = a_k_fast<op>() ? e / kBKH : e % kBM;
      const int k = a_k_fast<op>() ? e % kBKH : e / kBM;
      ra[i] = prod_a<op>(p, m0 + m, kb + k, k1);
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int e = tid + i * kThreads;
      const int n = b_k_fast<op>() ? e / kBKH : e % kBN;
      const int k = b_k_fast<op>() ? e % kBKH : e / kBN;
      rb[i] = prod_b<op>(p, kb + k, n0 + n, k1);
    }
  };
  fetch(k0);
  for (long long kb = k0; kb < k1; kb += kBKH) {
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int e = tid + i * kThreads;
      as[a_k_fast<op>() ? e / kBKH : e % kBM]
        [a_k_fast<op>() ? e % kBKH : e / kBM] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int e = tid + i * kThreads;
      bs[b_k_fast<op>() ? e / kBKH : e % kBN]
        [b_k_fast<op>() ? e % kBKH : e / kBN] = rb[i];
    }
    __syncthreads();
    if (kb + kBKH < k1) fetch(kb + kBKH);
#pragma unroll
    for (int kk = 0; kk < kBKH; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int m = wm * 32 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4(a[mt], smem_u32(&as[m][kk + (lane >> 4) * 8]));
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        const int n = wn * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8;
        ldsm_x4(r, smem_u32(&bs[n][kk + ((lane >> 3) & 1) * 8]));
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_16816(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
  }
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long m = m0 + wm * 32 + mt * 16 + g + (r >= 2 ? 8 : 0);
        const int n = n0 + wn * 32 + nt * 8 + 2 * q + (r & 1);
        prod_out<op>(p, m, n, acc[mt][nt][r], blockIdx.z);
      }
}

bool fits(int C, int H) {
  return C >= 1 && C <= kMaxC && H >= 1 && H <= kMaxH;
}

int dw_chunks(long long TB) {
  return (int)((TB + kDwChunkRows - 1) / kDwChunkRows);
}

template <Op op, typename T>
void launch_prod(const Prod<T>& p, int chunks, cudaStream_t stream) {
  const long long M = op == kDw ? p.C + p.H + 1 : p.TB;
  const int N = op == kDx ? p.C : 4 * p.H;
  const dim3 grid((N + kBN - 1) / kBN, (unsigned)((M + kBM - 1) / kBM),
                  op == kDw ? chunks : 1);
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return;
  if constexpr (sizeof(T) == 4) {
    wide_gemm_f32_kernel<op><<<grid, kThreads, 0, stream>>>(p);
  } else {
    wide_gemm_bf16_kernel<op><<<grid, kThreads, 0, stream>>>(p);
  }
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

template <typename T>
int launch_bwd(const void* x, const void* w_aug, const void* w_ht,
               const void* hs, const void* cs, const void* dhs, void* z,
               void* dg, void* dx, void* partials, void* dw, int n_steps,
               int B, int C, int H, void* stream) {
  if (n_steps < 0 || B < 1 || !fits(C, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  Prod<T> p;
  p.x = static_cast<const T*>(x);
  p.hs = static_cast<const T*>(hs);
  p.w = static_cast<const T*>(w_aug);
  p.dg = static_cast<const T*>(dg);
  p.z = static_cast<float*>(z);
  p.dx = static_cast<T*>(dx);
  p.partials = static_cast<float*>(partials);
  p.TB = (long long)n_steps * B;
  p.B = B;
  p.C = C;
  p.H = H;
  const int chunks = dw_chunks(p.TB);
  launch_prod<kGates>(p, chunks, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(wide_rec_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kRecSmem);
  if (err != cudaSuccess) return (int)err;
  if (n_steps > 0) {
    wide_rec_kernel<T><<<(B + kRows - 1) / kRows, kThreads, kRecSmem, s>>>(
        p.z, static_cast<const T*>(cs), static_cast<const T*>(dhs),
        static_cast<const T*>(w_ht), static_cast<T*>(dg), n_steps, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  launch_prod<kDx>(p, chunks, s);
  launch_prod<kDw>(p, chunks, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = (C + H + 1) * 4 * H;
  // dW = the chunks' partials summed in chunk order
  launch_ordered_sum<0>(p.partials, static_cast<float*>(dw), chunks, n, s);
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

// K3: w_ht is W_aug[C:C+H]^T (4H, H); z (T, B, 4H) f32, dg (T, B, 4H) and
// partials (lstm_wide_dw_chunks, C+H+1, 4H) f32 are scratch
int lstm_wide_bwd(int bf16, const void* x, const void* w_aug,
                  const void* w_ht, const void* hs, const void* cs,
                  const void* dhs, void* z, void* dg, void* dx,
                  void* partials, void* dw, int n_steps, int B, int C, int H,
                  void* stream) {
  return bf16 ? launch_bwd<bf16_bits>(x, w_aug, w_ht, hs, cs, dhs, z, dg, dx,
                                      partials, dw, n_steps, B, C, H, stream)
              : launch_bwd<float>(x, w_aug, w_ht, hs, cs, dhs, z, dg, dx,
                                  partials, dw, n_steps, B, C, H, stream);
}

int lstm_wide_dw_chunks(int n_steps, int B) {
  return dw_chunks((long long)n_steps * B);
}

const char* lstm_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
