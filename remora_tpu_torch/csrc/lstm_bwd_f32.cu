// K3's f32 leg on Hopper (sm_90a): the training LSTM backward in one launch
// on the FP32 pipes, with register tiles that shared memory keeps fed.
//
// Replaces, for f32, remora_tpu/kernels/pallas_lstm.py::_bwd_kernel
// (launched by _bwd_call): the reverse-time backward of a single-layer LSTM
// over x (T, B, C) that recomputes the gates from the saved h and c, writes
// dx and sums dW_aug = sum_t [x_t ; h_{t-1} ; 1]^T . dgates_t. The bf16 leg
// runs lstm_bwd_mma.cu's tensor-core parts.
//
//   z_t = [x_t ; h_{t-1}] @ W_aug[:C+H] + b                  (16 x 4H)
//   dgates_t = gate math (z_t, c_t, c_{t-1}, dh_t, dc carry)  (16 x 4H)
//   [dx_t ; dh_{t-1}] = dgates_t @ W_aug[:C+H]^T              (16 x C+H)
//   dW_aug[:C+H] += [x_t ; h_{t-1}]^T @ dgates_t             (C+H x 4H)
//
// Bound at the main path's shape (T = 124, B = 2048, C = H = 64; H100 SXM,
// 67 TFLOP/s FP32): the three products are 49.93 GFLOP, >= 0.745 ms; the
// function's bytes (x, hs, cs, dhs read, dx and dW written, 325 MB) need
// 0.097 ms. The f32 contract (full FP32 FMAs, as the JAX kernel pins
// Precision.HIGHEST) keeps the products off the tensor cores. One launch
// keeps every operand in shared memory and registers: splitting the
// products out (as the bf16 leg does) would move ~1.3 GB more through HBM
// for gates and dgates and still leave a serial walk that must read and
// write them.
//
// What binds it is shared memory. An SM's shared memory delivers 128 bytes
// a cycle counted per lane: a 16-byte load costs a warp 4 cycles whether
// its lanes share addresses (a broadcast) or not, so a register tile of m
// x n outputs fed along the sum reads (m + n) / (m n) floats per FMA and
// keeps up with the 128 FMA a cycle only at <= 0.25. The dW tile must hold
// its accumulators for the whole walk: at 16 warps (128 registers a
// thread) it leaves room only for 8-output tiles in the other two
// products (0.75 floats an FMA); at 8 warps it takes 128 of 255 and
// leaves room for 32-output tiles.
//
// Design: one block of 8 warps (255 registers a thread) owns 16 batch rows
// and walks t = T-1 ... 0. W_aug[:C+H] sits in shared memory for the whole
// walk, k-major, gate columns interleaved by unit (column 4u + gate); row
// strides are 4 mod 8 words (8 mod 32 for the dx/dh halves), so the rows
// that one load instruction touches fall on distinct banks. Per step:
//   B (all warps, before the step's first barrier; nothing else runs there):
//      lane (rg, unit 8w + uq), rows rg + 4i: the dh and dc carries in f32
//      and _bwd_kernel's gate cotangents from the activations that A left
//      in shared memory; dgates to shared memory, the bias row of dW (the
//      dgates sum) accumulated there by lane row group; tanh(c_t); dx_{t+1}
//      from C's two halves, coalesced.
//   then, between the barriers, two roles:
//   C (warps 0-3): [dx_t ; dh_{t-1}] = dgates_t . W^T in two halves of the
//      4H sum, a lane 4 rows x 8 k (32 FFMA per 12 16-byte reads, 0.375
//      floats an FMA), into shared memory;
//   A (warps 4-7): z_{t-1} = [x_{t-1} ; h_{t-2}] . W + b, a lane 8 rows x
//      one unit's 4 gates (0.375), then the gate activations of step t-1
//      (expf, IEEE division, tanhf: _bwd_kernel's) into shared memory;
//   D (all): dW += [x_t ; h_{t-1}]^T . dgates_t, an 8 k x 16 column tile in
//      128 registers a thread for the whole walk (0.1875); warps 4-7 run it
//      before A, warps 0-3 after C, so the shared-memory-bound and the
//      FFMA-bound halves overlap.
//   Step t's [x_t ; h_{t-1}] arrives by cp.async into a ring of three
//   slots, issued two steps ahead; B's c_{t-1} and dh_t are loaded into
//   registers a step ahead (and prefetched into L2 one more). A's
//   activations and C's halves go through shared memory, so no value is
//   carried across a barrier in registers but the carries.
// Each block writes its partial dW_aug (bias row included) to an
// (n_blocks, C+H+1, 4H) f32 scratch and ordered_sum (mma_sm90.cuh) sums
// the partials in block order: no float atomics, and a repeated call gives
// the same bits. The main path's shape (C = H = 64) is a compile-time
// instantiation, so strides and trip counts fold into the instructions.
//
// Chain a step (chip_smoke.py::lstm_chain_instrs("bwd")): BAR -> LDS the
// two dh halves -> FADD them, FADD dhs -> dc (FMUL, FMUL, FADD) -> dgates
// (3 FMUL) -> STS -> BAR -> LDS -> 2H dependent FFMA (a half of dh) -> STS.
// The gate recompute and its activations are off it: they need only the
// saved x, h and c.
//
// Shapes: C <= 128, H <= 64 and ceil((C+H)/8) * ceil(H/4) <= 256 dW tiles
// (C + H <= 128 at H = 64): kernels/lstm.py::bwd_f32_shape_error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;   // batch rows a block; two staged rows a warp
constexpr int kMaxC = 128;
constexpr int kUnits = 8;   // B: hidden units a warp
constexpr int kMaxH = kUnits * kWarps;
constexpr int kRoleWarps = kWarps / 2;  // C on warps 0-3, A on warps 4-7
constexpr int kAUnits = kMaxH / kRoleWarps;  // A: hidden units a warp
constexpr int kSlots = 3;   // [x_t ; h_{t-1}] ring
constexpr int kTileK = 8;   // dW tile: 8 k x 16 gate columns
constexpr int kTileP = 16;
constexpr int kCK = 64;     // C: k rows an item (8 lanes x 8)
constexpr size_t kMaxSmem = 232448;

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

struct Layout {
  int K, G;
  int Hp, Gp;  // units padded to B's 8 a warp, their gate columns
  int Kp;      // W rows, padded to 8 with zeros
  int Ws, Xs, Gs, Ds;  // row strides (words): W, [x;h], dgates/act, dxh
  int Gd;      // dW's gate columns, padded to 16
  int n_kt, n_gt;
  size_t w, xh, dg, act, dxh, bias, bsum, total;
};

__host__ __device__ inline Layout layout(int C, int H) {
  Layout L;
  L.K = C + H;
  L.G = 4 * H;
  L.Hp = round_up(H, kUnits);
  L.Gp = 4 * L.Hp;
  L.Kp = round_up(L.K, 8);
  // a stride of 4 mod 8 words puts consecutive rows' 16-byte runs on
  // distinct banks; the dxh stride is 8 mod 32 (4 rows x 8 k a store)
  L.Ws = L.Gp + 4;
  L.Xs = L.Kp + 4;
  L.Gs = L.Gp + 4;
  L.Ds = round_up(L.K > 8 ? L.K - 8 : 0, 32) + 8;
  L.Gd = round_up(L.G, kTileP);
  L.n_kt = (L.K + kTileK - 1) / kTileK;
  L.n_gt = L.Gd / kTileP;
  L.w = 0;
  L.xh = L.w + (size_t)L.Kp * L.Ws * 4;
  L.dg = L.xh + (size_t)kSlots * kRows * L.Xs * 4;
  L.act = L.dg + (size_t)kRows * L.Gs * 4;
  L.dxh = L.act + (size_t)kRows * L.Gs * 4;
  L.bias = L.dxh + (size_t)2 * kRows * L.Ds * 4;
  L.bsum = L.bias + (size_t)L.Gp * 4;
  L.total = L.bsum + (size_t)4 * L.Gp * 4;
  return L;
}

// every dW tile has a thread and the layout fits a block's shared memory
__host__ inline bool fits(int C, int H) {
  if (C < 1 || H < 1 || C > kMaxC || H > kMaxH) return false;
  const Layout L = layout(C, H);
  return L.n_kt * L.n_gt <= kThreads && L.total <= kMaxSmem;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

// A for one lane: z[i][g] = b + sum_k xh[row 2i + rg][k] W[k][4u + g] (k
// ascending) for its 8 rows, then the gate activations (expf, IEEE
// division, tanhf) into act[row][4u + g]
__device__ __forceinline__ void gate_tile(const float* xs, int Xs,
                                          const float* wcol,
                                          const float* bias, int K4, int Ws,
                                          float* act, int Gs) {
  float z[8][4];
  const float4 b4 = load4(bias);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    z[i][0] = b4.x;
    z[i][1] = b4.y;
    z[i][2] = b4.z;
    z[i][3] = b4.w;
  }
  for (int k = 0; k < K4; k += 4) {
    float v[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 xa = load4(xs + 2 * i * Xs + k);
      v[i][0] = xa.x;
      v[i][1] = xa.y;
      v[i][2] = xa.z;
      v[i][3] = xa.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 w = load4(wcol + (k + j) * Ws);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        z[i][0] = fmaf(v[i][j], w.x, z[i][0]);
        z[i][1] = fmaf(v[i][j], w.y, z[i][1]);
        z[i][2] = fmaf(v[i][j], w.z, z[i][2]);
        z[i][3] = fmaf(v[i][j], w.w, z[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float ig = sigmoid(z[i][0]);
    const float fg = sigmoid(z[i][1]);
    const float gg = tanhf(z[i][2]);
    const float og = sigmoid(z[i][3]);
    *reinterpret_cast<float4*>(act + 2 * i * Gs) =
        make_float4(ig, fg, gg, og);
  }
}

// kC, kH > 0: a shape fixed at compile time (the main path's C = H = 64),
// so every stride and trip count folds into the instructions; 0: any shape
template <bool kVec, int kC, int kH>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_bwd_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w_aug,
                        const float* __restrict__ hs,
                        const float* __restrict__ cs,
                        const float* __restrict__ dhs, float* __restrict__ dx,
                        float* __restrict__ partials, int n_steps, int B,
                        int C_arg, int H_arg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = kC > 0 ? kC : C_arg;
  const int H = kH > 0 ? kH : H_arg;
  const Layout L = layout(C, H);
  const int K = L.K, G = L.G, Ws = L.Ws, Xs = L.Xs, Gs = L.Gs, Ds = L.Ds;
  float* ws = reinterpret_cast<float*>(smem + L.w);
  float* xh = reinterpret_cast<float*>(smem + L.xh);
  float* dg = reinterpret_cast<float*>(smem + L.dg);
  // the gate activations of the next step, [row][4u + gate]
  float* act = reinterpret_cast<float*>(smem + L.act);
  float* dxh = reinterpret_cast<float*>(smem + L.dxh);
  float* bias = reinterpret_cast<float*>(smem + L.bias);
  // the bias row of dW (the dgates sum) by B's lane row groups: [rg][4u+g]
  float* bsum = reinterpret_cast<float*>(smem + L.bsum);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.x * kRows;

  // W_aug[:C+H] as [k][4u + gate], zero past K rows and G columns; the
  // bias row the same way
  for (int e = tid; e < L.Kp * Ws; e += kThreads) {
    const int k = e / Ws, c = e - k * Ws;
    ws[e] = (k < K && c < G) ? w_aug[(size_t)k * G + (c & 3) * H + (c >> 2)]
                             : 0.f;
  }
  for (int c = tid; c < L.Gp; c += kThreads) {
    bias[c] = c < G ? w_aug[(size_t)K * G + (c & 3) * H + (c >> 2)] : 0.f;
  }
  // the slots' k padding stays 0; the first step's dh carry is 0
  for (int e = tid; e < kSlots * kRows * Xs; e += kThreads) xh[e] = 0.f;
  for (int e = tid; e < 2 * kRows * Ds; e += kThreads) dxh[e] = 0.f;
  for (int e = tid; e < 4 * L.Gp; e += kThreads) bsum[e] = 0.f;
  __syncthreads();

  // step s's [x_s ; h_{s-1}] into slot s % kSlots, warp w its rows 2w and
  // 2w + 1 (rows past B and h_{-1} zero); one cp.async group a call, empty
  // for s < 0
  auto stage = [&](int s) {
    if (s >= 0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = 2 * warp + q;
        float* dst = xh + (s % kSlots) * kRows * Xs + r * Xs;
        const int row = b0 + r;
        const bool rv = row < B;
        const bool hv = rv && s > 0;
        const float* xrow = x + ((size_t)s * B + (rv ? row : 0)) * C;
        const float* hrow =
            hs + ((size_t)(s > 0 ? s - 1 : 0) * B + (rv ? row : 0)) * H;
        if (kVec) {
          for (int k = lane * 4; k < K; k += 128) {
            if (k < C) {
              cp_async16z(dst + k, xrow + k, rv);
            } else {
              cp_async16z(dst + k, hrow + (k - C), hv);
            }
          }
        } else {
          for (int k = lane; k < K; k += 32) {
            if (k < C) {
              cp_async4(dst + k, xrow + k, rv);
            } else {
              cp_async4(dst + k, hrow + (k - C), hv);
            }
          }
        }
      }
    }
    cp_async_commit();
  };

  // B lanes: unit u = 8 warp + (lane & 7), rows rg + 4i
  const int rg = lane >> 3;
  const int u = kUnits * warp + (lane & 7);
  const bool ab_active = kUnits * warp < L.Hp;

  // C lanes (warps 0-3): rows rg + 4i, k = kb * kCK + kl + 8j
  const bool c_warp = warp < kRoleWarps;
  const int kl = lane & 7;
  const int n_citems = 2 * ((K + kCK - 1) / kCK);
  const int half = L.Gp / 2;

  // A lanes (warps 4-7): unit ua, rows ra + 2i
  const int ua = kAUnits * (warp - kRoleWarps) + (lane & 15);
  const int ra = lane >> 4;
  const bool a_active = !c_warp && ua < L.Hp;
  const float* wcol = ws + 4 * ua;
  const int K4 = round_up(K, 4);
  auto gates = [&](int s) {  // act = the activations of step s
    const float* xs = xh + (s % kSlots) * kRows * Xs + ra * Xs;
    gate_tile(xs, Xs, wcol, bias + 4 * ua, K4, Ws, act + ra * Gs + 4 * ua,
              Gs);
  };

  // D: thread tid owns dW tile (kt, gt): rows 8 kt .. 8 kt + 7, columns
  // q Gd/4 + 4 gt + {0..3} for q < 4
  const bool dw_active = tid < L.n_kt * L.n_gt;
  const int kt = tid / L.n_gt, gt = tid - kt * L.n_gt;
  const int qd = L.Gd / 4;
  float acc[kTileK][kTileP];
#pragma unroll
  for (int a = 0; a < kTileK; ++a)
#pragma unroll
    for (int b = 0; b < kTileP; ++b) acc[a][b] = 0.f;

  // B's carries in f32 (c_t and dc) and its inputs (c_{t-1} and dh_t),
  // loaded at the end of the step before
  float c_cur[4], dcc[4], cprev[4], dhin[4];
  auto load_inputs = [&](int t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = b0 + rg + 4 * i;
      const bool ok = ab_active && u < H && row < B && t >= 0;
      const size_t at = ((size_t)(t >= 0 ? t : 0) * B + row) * H + u;
      cprev[i] = ok && t >= 1 ? cs[at - (size_t)B * H] : 0.f;
      dhin[i] = ok ? dhs[at] : 0.f;
      if (ok && t >= 1) {
        prefetch_l2(dhs + (at - (size_t)B * H));
        if (t >= 2) prefetch_l2(cs + (at - (size_t)2 * B * H));
      }
    }
  };
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = b0 + rg + 4 * i;
    const bool ok = ab_active && u < H && row < B && n_steps > 0;
    c_cur[i] = ok ? cs[((size_t)(n_steps - 1) * B + row) * H + u] : 0.f;
    dcc[i] = 0.f;
  }
  load_inputs(n_steps - 1);

  stage(n_steps - 1);
  stage(n_steps - 2);
  cp_async_wait<1>();
  __syncthreads();
  if (a_active && n_steps > 0) gates(n_steps - 1);
  __syncthreads();

  for (int t = n_steps - 1; t >= 0; --t) {
    stage(t - 2);

    // B: gate cotangents (_bwd_kernel's math) of step t
    if (ab_active) {
      float4 bs = load4(bsum + rg * L.Gp + 4 * u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 4 * i;
        const bool ok = u < H && b0 + r < B;
        const float4 a4 = load4(act + r * Gs + 4 * u);
        const float ig = a4.x, fg = a4.y, gg = a4.z, og = a4.w;
        const float tanh_c = tanhf(c_cur[i]);
        const float dhc =
            u < H ? dxh[r * Ds + C + u] + dxh[(kRows + r) * Ds + C + u]
                  : 0.f;
        const float dh = dhin[i] + dhc;
        const float d_o = dh * tanh_c;
        const float dc = dcc[i] + dh * og * (1.f - tanh_c * tanh_c);
        const float dgi = ok ? dc * gg * ig * (1.f - ig) : 0.f;
        const float dgf = ok ? dc * cprev[i] * fg * (1.f - fg) : 0.f;
        const float dgg = ok ? dc * ig * (1.f - gg * gg) : 0.f;
        const float dgo = ok ? d_o * og * (1.f - og) : 0.f;
        *reinterpret_cast<float4*>(dg + r * Gs + 4 * u) =
            make_float4(dgi, dgf, dgg, dgo);
        bs.x += dgi;
        bs.y += dgf;
        bs.z += dgg;
        bs.w += dgo;
        dcc[i] = ok ? dc * fg : 0.f;
        c_cur[i] = cprev[i];
      }
      *reinterpret_cast<float4*>(bsum + rg * L.Gp + 4 * u) = bs;
    }
    // dx_{t+1} = the sum of C's two halves, warp w its rows 2w, 2w + 1
    if (t + 1 < n_steps) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = 2 * warp + q;
        if (b0 + r < B) {
          float* dx_row = dx + ((size_t)(t + 1) * B + b0 + r) * C;
          for (int k = lane; k < C; k += 32) {
            dx_row[k] = dxh[r * Ds + k] + dxh[(kRows + r) * Ds + k];
          }
        }
      }
    }
    cp_async_wait<1>();  // step t-1's slot has landed
    __syncthreads();     // dgates written; dh partials and dx read
    load_inputs(t - 1);  // B's inputs of step t-1, under this step's work

    // C (warps 0-3): [dx_t ; dh_{t-1}] halves = dgates . W^T
    for (int item = warp; c_warp && item < n_citems; item += kRoleWarps) {
      const int kb = item >> 1, s = item & 1;
      const int k0 = kb * kCK + kl;
      const float* w_row[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        w_row[j] = ws + min(k0 + 8 * j, L.Kp - 1) * Ws;
      }
      float d[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) d[i][j] = 0.f;
      const int p1 = (s + 1) * half;
      for (int p = s * half; p < p1; p += 4) {
        float4 g[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) g[i] = load4(dg + (rg + 4 * i) * Gs + p);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 w = load4(w_row[j] + p);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            d[i][j] = fmaf(g[i].x, w.x, d[i][j]);
            d[i][j] = fmaf(g[i].y, w.y, d[i][j]);
            d[i][j] = fmaf(g[i].z, w.z, d[i][j]);
            d[i][j] = fmaf(g[i].w, w.w, d[i][j]);
          }
        }
      }
      float* out = dxh + s * kRows * Ds;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + 8 * j;
        if (k < K) {
#pragma unroll
          for (int i = 0; i < 4; ++i) out[(rg + 4 * i) * Ds + k] = d[i][j];
        }
      }
    }

    // D: dW[k][col] += sum_rows [x;h][row][k] * dgates[row][col]
    if (dw_active) {
      const float* xk = xh + (t % kSlots) * kRows * Xs + kt * kTileK;
      const float* gk = dg + 4 * gt;
#pragma unroll 2
      for (int r = 0; r < kRows; ++r) {
        const float4 x0 = load4(xk + r * Xs);
        const float4 x1 = load4(xk + r * Xs + 4);
        float gv[kTileP];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 g = load4(gk + r * Gs + q * qd);
          gv[4 * q] = g.x;
          gv[4 * q + 1] = g.y;
          gv[4 * q + 2] = g.z;
          gv[4 * q + 3] = g.w;
        }
        const float xv[kTileK] = {x0.x, x0.y, x0.z, x0.w,
                                  x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int a = 0; a < kTileK; ++a)
#pragma unroll
          for (int b = 0; b < kTileP; ++b)
            acc[a][b] = fmaf(xv[a], gv[b], acc[a][b]);
      }
    }

    // A (warps 4-7): the activations of step t-1
    if (a_active && t >= 1) gates(t - 1);
    __syncthreads();  // dh partials written; slot t free
  }
  cp_async_wait<0>();

  // dx_0
  if (n_steps > 0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = 2 * warp + q;
      if (b0 + r < B) {
        float* dx_row = dx + ((size_t)b0 + r) * C;
        for (int k = lane; k < C; k += 32) {
          dx_row[k] = dxh[r * Ds + k] + dxh[(kRows + r) * Ds + k];
        }
      }
    }
  }

  // this block's partial dW_aug, gate-major [k][gate * H + unit], staged
  // in W's space so it leaves coalesced; the bias row from B's sums, row
  // groups added in order
  float* out = ws;
  if (dw_active) {
#pragma unroll
    for (int a = 0; a < kTileK; ++a) {
      const int k = kt * kTileK + a;
#pragma unroll
      for (int b = 0; b < kTileP; ++b) {
        const int p = (b >> 2) * qd + 4 * gt + (b & 3);
        if (k < K && p < G) out[k * G + (p & 3) * H + (p >> 2)] = acc[a][b];
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < G; j += kThreads) {
    const int c = 4 * (j % H) + j / H;
    float s = 0.f;
    for (int q = 0; q < 4; ++q) s += bsum[q * L.Gp + c];
    out[K * G + j] = s;
  }
  __syncthreads();
  float* part = partials + (size_t)blockIdx.x * (K + 1) * G;
  for (int e = tid; e < (K + 1) * G; e += kThreads) part[e] = out[e];
}

int n_blocks(int B) { return (B + kRows - 1) / kRows; }

template <bool kVec, int kC, int kH>
cudaError_t launch_main(const float* x, const float* w_aug, const float* hs,
                        const float* cs, const float* dhs, float* dx,
                        float* partials, int n_steps, int B, int C, int H,
                        size_t smem, cudaStream_t stream) {
  auto kernel = lstm_bwd_f32_kernel<kVec, kC, kH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks(B), kThreads, smem, stream>>>(
      x, w_aug, hs, cs, dhs, dx, partials, n_steps, B, C, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launches (0 = launched). partials:
// (lstm_bwd_f32_blocks(B), C+H+1, 4H) f32 scratch; dw: (C+H+1, 4H) f32.
int lstm_bwd_f32(const void* x, const void* w_aug, const void* hs,
                 const void* cs, const void* dhs, void* dx, void* partials,
                 void* dw, int n_steps, int B, int C, int H, void* stream) {
  if (n_steps < 0 || B < 1 || !fits(C, H)) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L = layout(C, H);
  const cudaStream_t s = (cudaStream_t)stream;
  // 16-byte copies where every row of x and hs starts 16-byte aligned
  const bool vec = C % 4 == 0 && H % 4 == 0 &&
                   ((uintptr_t)x | (uintptr_t)hs) % 16 == 0;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w_aug);
  const float* hf = static_cast<const float*>(hs);
  const float* cf = static_cast<const float*>(cs);
  const float* df = static_cast<const float*>(dhs);
  float* dxf = static_cast<float*>(dx);
  float* pf = static_cast<float*>(partials);
  cudaError_t err;
  if (vec && C == 64 && H == 64) {
    err = launch_main<true, 64, 64>(xf, wf, hf, cf, df, dxf, pf, n_steps, B,
                                    C, H, L.total, s);
  } else if (vec) {
    err = launch_main<true, 0, 0>(xf, wf, hf, cf, df, dxf, pf, n_steps, B, C,
                                  H, L.total, s);
  } else {
    err = launch_main<false, 0, 0>(xf, wf, hf, cf, df, dxf, pf, n_steps, B,
                                   C, H, L.total, s);
  }
  if (err != cudaSuccess) return (int)err;
  const int n_elems = (C + H + 1) * 4 * H;
  // dW = the sum over blocks of the partials, in block order
  launch_ordered_sum<0>(pf, static_cast<float*>(dw), n_blocks(B), n_elems,
                        s);
  return (int)cudaGetLastError();
}

int lstm_bwd_f32_blocks(int B) { return n_blocks(B); }
int lstm_bwd_f32_fits(int C, int H) { return fits(C, H) ? 1 : 0; }

const char* lstm_bwd_f32_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
