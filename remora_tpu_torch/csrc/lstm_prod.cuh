// The LSTM backward's products off the serial chain, shared by the K3 legs
// that run them as launches of their own (lstm_wide_bwd.cu at C, H <= 128,
// lstm_general.cu above), f32 and bf16, sm_90a:
//   (a) the gate recompute Z = [x_t ; h_{t-1}] . W_aug[:C+H] + b for every
//       (t, row) at once, f32; its x part alone, Z_x = x_t . W_x + b (op
//       kGatesX, f32 out), is the general forward's W_h-ring path's
//       (lstm_general_cluster.cu, f32 operands) and its ring path's
//       (lstm_general_fwd_ring.cu, bf16 operands);
//   (c) dx = dgates . W_x^T, rounded once, and dW_aug = [x ; h_{t-1}]^T .
//       dgates over fixed chunks of kDwChunkRows rows into f32 partials (the
//       bias row, the dgates column sums, taken by the chunk's first row
//       tile), which ordered_sum (mma_sm90.cuh) sums in chunk order: no
//       atomics, and a repeated call gives the same bits.
// Each product tiles M and N and loops over its K in stages, so it takes
// any C and H (the callers' shape checks bound them). The f32 products run
// prod_f32_ws_kernel wherever C and H are multiples of 4 and the operands
// lie on 16-byte boundaries (p.vec), else wide_prod_f32_kernel, today's
// element path; launch_f32_op picks once, by shape, and never falls back.
//
// Design (the plain twins are kernels/lstm.py's lstm_bwd_gates_reference
// and lstm_bwd_products_reference; lstm_prod_f32 runs each op alone):
//   prod_f32_ws_kernel (f32, sm_90a; replaces no TPU kernel of its own: it
//     is the products of pallas_lstm.py's _bwd_kernel, phase 1's gate
//     recompute and the dx/dW tail, and of _fwd_kernel's x_t . W_x). FP32
//     operations bind it (2 TB (C + H) 4H FLOP for the gates and dW, 2 TB
//     4H C for dx and Z_x, at 67 TFLOP/s; the bytes take a tenth of that),
//     so the design keeps the FFMA pipes fed and nothing else on them.
//     One persistent block an SM walks the output tiles in a static order,
//     n fastest (A read from device memory about once, W from L2). Three
//     warpgroups with setmaxnreg: the producer group (24 registers) runs
//     one warp a ring, whose lane 0 loads each k-stage of 32 by TMA tiled
//     copies (a CUtensorMap an operand, cuTensorMapEncodeTiled fetched
//     from the CUDA driver at run time; [x_m ; h_{m-B}] as two maps, h at
//     row m - B, whose rows below 0 TMA fills with zeros: h_{-1} = 0) into
//     a ring of 2 or 3 slots with full/empty mbarriers; each consumer group
//     (240 registers) owns every other tile of the block and its own ring,
//     and runs shared loads and FFMA alone, no CTA barrier, so one group's
//     epilogue runs under the other's main loop and a tile's ring fill is
//     paid once a block. Edited copies on an H100 (C = H = 160, 256) run
//     as fast without the TMA loads and without the stores: the FFMA loop
//     binds, at 66-74% of the FP32 peak (PERF.md). A thread owns TM x TN outputs of a (WM TM) x (WN
//     TN) tile (WM x WN threads): rows tm + WM i and float4 column chunks
//     4 tn + 4 WN j; A staged [m][k] by TMA's 128-byte swizzle (a warp's
//     float4 reads along k hit distinct banks) or, for dW, [k][m] with
//     float4 chunks along m. Tiles fit the model widths: 128 x 128 for the
//     gates and Z_x; dx's N = C 128, 96 or 160 columns; dW's M tiled per
//     part (x's C rows, then h's H) by 128, 96 or 160, the least padded.
//     Bits: each output is one FFMA chain in k order from 0, the bias (0
//     for dx and dW) added last, dW in kDwChunkRows chunks with the bias
//     row the x part's first tile's column sums: the element path's bits
//     (k stages of zeros between x's and h's k where C is not a multiple
//     of 32 add exact zeros).
//   wide_prod_f32_kernel: block tiles of up to 128 x 128, a thread 2MC x
//     2NC outputs (8 x 8 at most) from float2 chunks 32 apart; the variable
//     dimension's tile (dx's N = C, the gates' N = 4H: 32 NC wide; dW's M =
//     C + H: 32, 64 or 128 rows, since a 96-row tile spills) is sized to the
//     dimension, so dx at C = 96 and dW at C + H = 192 and 256 compute no
//     padding. Operands staged by 16-byte cp.async into a 3-stage ring, 32
//     k a stage, one barrier a stage; [x ; h_{t-1}] resolved once per
//     16-byte chunk (x, h or zero), a per-element edge path where C, H or a
//     pointer are not 16-byte multiples. Epilogues store float2 (dx, whose
//     C may be odd, by element), the bias held in registers.
//   wide_prod_bf16_kernel: the same staging, 64 k a stage, on mma.sync
//     (128 x 128 tiles, 8 warps of 64 x 32, ldmatrix from padded tiles);
//     the gates and Z_x add the bias after the k sum, as the f32 kernels.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16_bits v) {
  return __uint_as_float((uint32_t)v << 16);
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

namespace prod {

constexpr int kThreads = 256;
constexpr int kDwChunkRows = 2048;  // dW's K rows a chunk
constexpr int kStages = 3;          // the cp.async ring
constexpr int kTile = 128;          // the largest tile side

enum Op { kGates, kDx, kDw, kGatesX };

template <typename T>
struct Prod {
  const T* x;
  const T* hs;
  const T* w;    // W_aug (C + H + 1, 4H)
  const T* wxt;  // W_x^T (4H, C)
  const T* dg;
  float* z;
  T* dx;
  float* partials;
  long long TB;  // T * B rows of x, hs and dgates
  int B, C, H;
  int vec;  // 16-byte staging: C, H multiples of 16 / sizeof(T), aligned
};

// Copy rows [r0, r0 + nr) x columns [c0, c0 + nc) of one of the products'
// source matrices into dst[r][c] (row stride ld elements), zero outside it.
// kXH: [x_m ; h_{m-B}] (zero for m < B), rows TB, columns C + H; else src
// (rows n_rows, columns n_cols, row stride n_cols). kVec: 16-byte cp.async,
// one branch per chunk; else element by element.
template <bool kXH, typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const Prod<T>& p,
                                      const T* src, long long n_rows,
                                      int n_cols, long long r0, int nr,
                                      int c0, int nc, bool vec) {
  constexpr int kE = 16 / sizeof(T);  // elements a chunk
  const int K = p.C + p.H;
  if (vec) {
    const int chunks = nc / kE;
    for (int e = threadIdx.x; e < nr * chunks; e += kThreads) {
      const int r = e / chunks, c = (e - r * chunks) * kE;
      const long long row = r0 + r;
      const int col = c0 + c;
      T* d = dst + r * ld + c;
      const T* s = nullptr;
      if (kXH) {
        if (row < p.TB) {
          if (col < p.C) {
            s = p.x + row * p.C + col;
          } else if (col < K && row >= p.B) {
            s = p.hs + (row - p.B) * p.H + (col - p.C);
          }
        }
      } else if (row < n_rows && col < n_cols) {
        s = src + row * n_cols + col;
      }
      cp_async16z(d, s != nullptr ? s : p.x, s != nullptr);
    }
  } else {
    for (int e = threadIdx.x; e < nr * nc; e += kThreads) {
      const int r = e / nc, c = e - r * nc;
      const long long row = r0 + r;
      const int col = c0 + c;
      T v = T(0);
      if (kXH) {
        if (row < p.TB) {
          if (col < p.C) {
            v = p.x[row * p.C + col];
          } else if (col < K && row >= p.B) {
            v = p.hs[(row - p.B) * p.H + (col - p.C)];
          }
        }
      } else if (row < n_rows && col < n_cols) {
        v = src[row * n_cols + col];
      }
      dst[r * ld + c] = v;
    }
  }
}

// the product's dimensions and this block's k range (dW: chunk blockIdx.z)
template <Op op, typename T>
__device__ __forceinline__ long long prod_m(const Prod<T>& p) {
  return op == kDw ? p.C + p.H : p.TB;
}
template <Op op, typename T>
__device__ __forceinline__ int prod_n(const Prod<T>& p) {
  return op == kDx ? p.C : 4 * p.H;
}
template <Op op, typename T>
__device__ __forceinline__ void prod_k(const Prod<T>& p, long long* k0,
                                       long long* k1) {
  if (op == kDw) {
    *k0 = (long long)blockIdx.z * kDwChunkRows;
    *k1 = min(p.TB, *k0 + kDwChunkRows);
  } else {
    *k0 = 0;
    *k1 = op == kGates ? p.C + p.H : op == kGatesX ? p.C : 4 * p.H;
  }
}

// Stage k slice [kb, kb + kBK) of A and B into one ring slot. A is [m][k]
// (the gates: [x ; h], dx: dgates) or, for dW, [k][m] ([x ; h] rows as
// they lie); B is [k][n] (the gates: W_aug, dx: W_x^T, dW: dgates).
template <Op op, int kBM, int kBN, int kBK, typename T>
__device__ __forceinline__ void stage_ab(T* as, int lda, T* bs, int ldb,
                                         const Prod<T>& p, long long m0,
                                         int n0, long long kb, long long k1,
                                         bool vec) {
  const int nk = (int)min((long long)kBK, k1 - kb);
  const int G = 4 * p.H;
  if constexpr (op == kGatesX) {
    // x (TB, C) alone: A's columns and W's rows past C are zero
    stage<false>(as, lda, p, p.x, p.TB, p.C, m0, kBM, (int)kb, kBK, vec);
    stage<false>(bs, ldb, p, p.w, p.C, G, kb, kBK, n0, kBN, vec);
  } else if (op == kGates) {
    // A: k columns past nk read [x ; h]'s next columns or zeros; W's rows
    // past C + H are zero, so they add nothing
    stage<true>(as, lda, p, (const T*)nullptr, 0, 0, m0, kBM, (int)kb, kBK,
                vec);
    stage<false>(bs, ldb, p, p.w, p.C + p.H, G, kb, kBK, n0, kBN, vec);
  } else if (op == kDx) {
    stage<false>(as, lda, p, p.dg, p.TB, G, m0, kBM, (int)kb, kBK, vec);
    stage<false>(bs, ldb, p, p.wxt, G, p.C, kb, kBK, n0, kBN, vec);
  } else {
    // the chunk's rows end at k1: rows past it are zero in both operands
    stage<true>(as, lda, p, (const T*)nullptr, 0, 0, kb, nk, (int)m0, kBM,
                vec);
    stage<false>(bs, ldb, p, p.dg, k1, G, kb, nk, n0, kBN, vec);
    for (int e = threadIdx.x; e < (kBK - nk) * (kBM + kBN); e += kThreads) {
      const int r = nk + e / (kBM + kBN), c = e % (kBM + kBN);
      if (c < kBM) {
        as[r * lda + c] = T(0);
      } else {
        bs[r * ldb + c - kBM] = T(0);
      }
    }
  }
}

// The chunk's dgates column sums (dW's bias row) over a staged B slice: thread
// n < kBN adds column n's kBK rows in order.
template <int kBN, int kBK, typename T>
__device__ __forceinline__ void column_sums(const T* bs, int ldb, float* sum) {
  if (threadIdx.x < kBN) {
    for (int k = 0; k < kBK; ++k) *sum += widen(bs[k * ldb + threadIdx.x]);
  }
}

// f32: thread (tm, tn) owns rows 2 tm + 32 c + {0, 1} (c < MC) and columns
// 2 tn + 32 c + {0, 1} (c < NC) of the (32 MC) x (32 NC) tile.
// Two blocks an SM (128 registers) but for dx's and Z_x's full 128-column
// tiles, whose 8 x 8 thread tile needs more and runs one block an SM
// unspilled (Z_x's spilled 28 bytes at two: 3.70 ms against 3.78 at one,
// C = H = 256, T = 124, B = 2048 on an H100).
template <Op op, int MC, int NC>
__global__ void __launch_bounds__(kThreads,
                                  (op == kDx || op == kGatesX) && NC == 4 ? 1
                                                                          : 2)
    wide_prod_f32_kernel(Prod<float> p) {
  constexpr int kBM = 32 * MC, kBN = 32 * NC, kBK = 32;
  constexpr bool kAkm = op == kDw;  // A staged [k][m]
  constexpr int kLda = kAkm ? kBM + 4 : kBK + 4;
  constexpr int kASize = kAkm ? kBK * kLda : kBM * kLda;
  constexpr int kLdb = kBN + 4;
  constexpr int kBSize = kBK * kLdb;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x, tm = tid >> 4, tn = tid & 15;
  const long long m0 = (long long)blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const long long M = prod_m<op>(p);
  const int N = prod_n<op>(p);
  long long k0, k1;
  prod_k<op>(p, &k0, &k1);
  const int nst = (int)((k1 - k0 + kBK - 1) / kBK);
  const bool vec = p.vec != 0;
  const bool bias_sums = op == kDw && blockIdx.y == 0;

  float acc[2 * MC][2 * NC];
#pragma unroll
  for (int i = 0; i < 2 * MC; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NC; ++j) acc[i][j] = 0.f;
  float bsum = 0.f;

  auto slot_a = [&](int s) { return ring + s * (kASize + kBSize); };
  auto slot_b = [&](int s) { return ring + s * (kASize + kBSize) + kASize; };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) {
      stage_ab<op, kBM, kBN, kBK>(slot_a(s), kLda, slot_b(s), kLdb, p, m0,
                                  n0, k0 + (long long)s * kBK, k1, vec);
    }
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slot st is in; slot st - 1 is free
    const int nxt = st + kStages - 1;
    if (nxt < nst) {
      stage_ab<op, kBM, kBN, kBK>(slot_a(nxt % kStages), kLda,
                                  slot_b(nxt % kStages), kLdb, p, m0, n0,
                                  k0 + (long long)nxt * kBK, k1, vec);
    }
    cp_async_commit();
    const float* as = slot_a(st % kStages);
    const float* bs = slot_b(st % kStages);
    if (bias_sums) column_sums<kBN, kBK>(bs, kLdb, &bsum);
    if (kAkm) {
#pragma unroll 1
      for (int k = 0; k < kBK; ++k) {
        float av[2 * MC], bv[2 * NC];
#pragma unroll
        for (int c = 0; c < MC; ++c) {
          const float2 v = *reinterpret_cast<const float2*>(
              as + k * kLda + 2 * tm + 32 * c);
          av[2 * c] = v.x;
          av[2 * c + 1] = v.y;
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float2 v = *reinterpret_cast<const float2*>(
              bs + k * kLdb + 2 * tn + 32 * c);
          bv[2 * c] = v.x;
          bv[2 * c + 1] = v.y;
        }
#pragma unroll
        for (int i = 0; i < 2 * MC; ++i)
#pragma unroll
          for (int j = 0; j < 2 * NC; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    } else {
#pragma unroll 1
      for (int kq = 0; kq < kBK; kq += 4) {
        float4 av[2 * MC];
#pragma unroll
        for (int c = 0; c < MC; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            av[2 * c + e] = *reinterpret_cast<const float4*>(
                as + (2 * tm + 32 * c + e) * kLda + kq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float bv[2 * NC];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float2 v = *reinterpret_cast<const float2*>(
                bs + (kq + kk) * kLdb + 2 * tn + 32 * c);
            bv[2 * c] = v.x;
            bv[2 * c + 1] = v.y;
          }
#pragma unroll
          for (int i = 0; i < 2 * MC; ++i) {
            const float a = kk == 0   ? av[i].x
                            : kk == 1 ? av[i].y
                            : kk == 2 ? av[i].z
                                      : av[i].w;
#pragma unroll
            for (int j = 0; j < 2 * NC; ++j)
              acc[i][j] = fmaf(a, bv[j], acc[i][j]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const int G = 4 * p.H;
  float bias[2 * NC];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + 2 * tn + 32 * c + e;
      bias[2 * c + e] =
          (op == kGates || op == kGatesX) && n < N
              ? p.w[(long long)(p.C + p.H) * G + n]
              : 0.f;
    }
#pragma unroll
  for (int ci = 0; ci < MC; ++ci)
#pragma unroll
    for (int ei = 0; ei < 2; ++ei) {
      const long long m = m0 + 2 * tm + 32 * ci + ei;
      if (m >= M) continue;
      const int i = 2 * ci + ei;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int n = n0 + 2 * tn + 32 * c;
        const float v0 = acc[i][2 * c] + bias[2 * c];
        const float v1 = acc[i][2 * c + 1] + bias[2 * c + 1];
        if (op == kDx) {  // C may be odd: element stores
          float* out = p.dx + m * p.C;
          if (n < N) out[n] = v0;
          if (n + 1 < N) out[n + 1] = v1;
          continue;
        }
        float* out = op == kGates || op == kGatesX
                         ? p.z + m * G
                         : p.partials +
                               ((long long)blockIdx.z * (p.C + p.H + 1) + m) *
                                   G;
        if (n + 1 < N) {
          *reinterpret_cast<float2*>(out + n) = make_float2(v0, v1);
        } else if (n < N) {
          out[n] = v0;
        }
      }
    }
  if (bias_sums && tid < kBN && n0 + tid < N) {
    p.partials[((long long)blockIdx.z * (p.C + p.H + 1) + p.C + p.H) * G +
               n0 + tid] = bsum;
  }
}

// bf16: 128 x 128 tiles; warp (wm, wn) = (warp & 1, warp >> 1) owns rows 64
// wm .. +63 and columns 32 wn .. +31 as 4 x 4 mma.sync tiles. A staged [m][k]
// (ldmatrix) or, for dW, [k][m] (ldmatrix.trans); B [k][n] (ldmatrix.trans).
template <Op op>
__global__ void __launch_bounds__(kThreads, 2)
    wide_prod_bf16_kernel(Prod<bf16_bits> p) {
  constexpr int kBM = kTile, kBN = kTile, kBK = 64;
  constexpr bool kAkm = op == kDw;
  constexpr int kLda = kAkm ? kBM + 8 : kBK + 8;
  constexpr int kASize = kAkm ? kBK * kLda : kBM * kLda;
  constexpr int kLdb = kBN + 8;
  constexpr int kBSize = kBK * kLdb;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_bits* ring = reinterpret_cast<bf16_bits*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const long long m0 = (long long)blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const long long M = prod_m<op>(p);
  const int N = prod_n<op>(p);
  long long k0, k1;
  prod_k<op>(p, &k0, &k1);
  const int nst = (int)((k1 - k0 + kBK - 1) / kBK);
  const bool vec = p.vec != 0;
  const bool bias_sums = op == kDw && blockIdx.y == 0;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
  float bsum = 0.f;

  auto slot_a = [&](int s) { return ring + s * (kASize + kBSize); };
  auto slot_b = [&](int s) { return ring + s * (kASize + kBSize) + kASize; };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) {
      stage_ab<op, kBM, kBN, kBK>(slot_a(s), kLda, slot_b(s), kLdb, p, m0,
                                  n0, k0 + (long long)s * kBK, k1, vec);
    }
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = st + kStages - 1;
    if (nxt < nst) {
      stage_ab<op, kBM, kBN, kBK>(slot_a(nxt % kStages), kLda,
                                  slot_b(nxt % kStages), kLdb, p, m0, n0,
                                  k0 + (long long)nxt * kBK, k1, vec);
    }
    cp_async_commit();
    const bf16_bits* as = slot_a(st % kStages);
    const bf16_bits* bs = slot_b(st % kStages);
    if (bias_sums) column_sums<kBN, kBK>(bs, kLdb, &bsum);
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int mb = wm * 64 + mt * 16;
        if (kAkm) {
          ldsm_x4_t(a[mt], smem_u32(as + (kk + (lane & 7) + (lane >> 4) * 8) *
                                             kLda +
                                         mb + ((lane >> 3) & 1) * 8));
        } else {
          ldsm_x4(a[mt],
                  smem_u32(as + (mb + (lane & 15)) * kLda + kk +
                           (lane >> 4) * 8));
        }
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldsm_x4_t(r, smem_u32(bs +
                              (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  kLdb +
                              wn * 32 + np * 16 + (lane >> 4) * 8));
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_16816(acc[mt][nt], a[mt], b[nt]);
    }
  }
  cp_async_wait<0>();

  const int G = 4 * p.H;
  const int g = lane >> 2, q = lane & 3;
  float bias[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn * 32 + nt * 8 + 2 * q + e;
      bias[nt][e] = (op == kGates || op == kGatesX) && n < N
                        ? widen(p.w[(long long)(p.C + p.H) * G + n])
                        : 0.f;
    }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const long long m = m0 + wm * 64 + mt * 16 + g + 8 * s;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn * 32 + nt * 8 + 2 * q;
        const float v0 = acc[mt][nt][2 * s] + bias[nt][0];
        const float v1 = acc[mt][nt][2 * s + 1] + bias[nt][1];
        if (op == kDx) {
          bf16_bits* out = p.dx + m * p.C;
          if (n + 1 < N && p.C % 2 == 0) {
            *reinterpret_cast<uint32_t*>(out + n) =
                (uint32_t)narrow<bf16_bits>(v0) |
                ((uint32_t)narrow<bf16_bits>(v1) << 16);
          } else {
            if (n < N) out[n] = narrow<bf16_bits>(v0);
            if (n + 1 < N) out[n + 1] = narrow<bf16_bits>(v1);
          }
        } else {
          float* out = op == kGates || op == kGatesX
                           ? p.z + m * G
                           : p.partials +
                                 ((long long)blockIdx.z * (p.C + p.H + 1) + m) *
                                     G;
          if (n + 1 < N) {
            *reinterpret_cast<float2*>(out + n) = make_float2(v0, v1);
          } else if (n < N) {
            out[n] = v0;
          }
        }
      }
    }
  if (bias_sums && tid < kBN && n0 + tid < N) {
    p.partials[((long long)blockIdx.z * (p.C + p.H + 1) + p.C + p.H) * G +
               n0 + tid] = bsum;
  }
}

// ---- prod_f32_ws_kernel: the f32 products on Hopper ----

constexpr int kWsThreads = 384;  // the producer group, two consumer groups
constexpr int kWsBK = 32;        // k a stage

// a consumer group's tile: WM x WN threads of TM x TN outputs; a stage's
// A (BM x 32 or, for dW, 32 x BM) and B (32 x BN) at 1024-byte boundaries,
// kSlots of them a ring; kUnrollAll unrolls a stage's 8 k quads (else 2)
template <Op op, int WM, int TM, int TN, int kSlots, bool kUnrollAll>
struct WsTile {
  static constexpr int WN = 128 / WM;
  static constexpr int BM = WM * TM, BN = WN * TN;
  static constexpr int kABytes = BM * kWsBK * 4, kBBytes = kWsBK * BN * 4;
  static constexpr int kBOff = (kABytes + 1023) / 1024 * 1024;
  static constexpr int kStage = (kBOff + kBBytes + 1023) / 1024 * 1024;
  // the rings, 1024 bytes to align them, the full and empty mbarriers
  static constexpr size_t kSmem =
      1024 + (size_t)2 * kSlots * kStage + 4 * kSlots * 8;
  static_assert(WM == 8 || WM == 16, "swizzled rows need WM % 8 == 0");
  static_assert(TN % 4 == 0 && (op != kDw || TM % 4 == 0),
                "float4 chunks along the contiguous dimensions");
  static_assert(BM <= 256 && BN <= 256, "a TMA box side is at most 256");
  static_assert(op != kDw || BN <= 128, "dW's column sums: a thread each");
};

// one tensor map an operand (a0, a1: A's x part and h part or dgates; b0,
// b1: B's), passed as a __grid_constant__ parameter
struct WsMaps {
  CUtensorMap a0, a1, b0, b1;
};

// 32-bit tile arithmetic: launch_ws refuses TB + BM past 2^31, and
// every op's tiles then stay below 2^31
struct WsGeo {
  int tiles;        // output tiles of the launch
  int tiles_n;      // along N
  int tiles_m;      // along M (dW: a chunk's, the x part's first)
  int tiles_mx;     // dW: the x part's
  int sx;           // k stages of x (the gates, Z_x)
  int stages;       // k stages a tile (dW: a whole chunk's)
};

// tile t's place: rows from m0 (dW: of the part h or x, chunk `chunk`),
// columns from n0, `nst` k stages
struct WsAt {
  int m0, n0, mt, chunk, nst;
  bool h;
};

template <Op op, int BM, int BN>
__device__ __forceinline__ WsAt ws_at(const WsGeo& g, const Prod<float>& p,
                                      int t) {
  WsAt at;
  const int r = t / g.tiles_n;
  at.n0 = (t - r * g.tiles_n) * BN;
  if constexpr (op == kDw) {
    at.mt = r % g.tiles_m;
    at.chunk = r / g.tiles_m;
    at.h = at.mt >= g.tiles_mx;
    at.m0 = (at.h ? at.mt - g.tiles_mx : at.mt) * BM;
    const int rows = min(kDwChunkRows, (int)p.TB - at.chunk * kDwChunkRows);
    at.nst = (rows + kWsBK - 1) / kWsBK;
  } else {
    at.mt = 0;
    at.chunk = 0;
    at.h = false;
    at.m0 = r * BM;
    at.nst = g.stages;
  }
  return at;
}

__device__ __forceinline__ void ws_bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// this thread arrives on `bar`, whose phase also waits for `bytes`
__device__ __forceinline__ void ws_expect_arrive(uint32_t bar,
                                                 uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void ws_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void ws_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA tiled copy of the box at (c0 innermost, c1) of `map` into dst,
// completing its bytes on `bar`; out-of-bounds elements read as zero
__device__ __forceinline__ void ws_load(uint32_t dst, const CUtensorMap* map,
                                        int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The producer warp of ring `ring`, one lane: each of its consumer group's
// tiles' k stages into the ring's next free slot. The gates' stages past
// x's sx read h (map a1, rows m - B) and W_h (b1); dW's read its chunk's
// rows of x or h (a0 or a1, rows r - B) and dgates (b0).
template <Op op, int BM, int BN, int kStage, int kBOff, int kSlots>
__device__ __forceinline__ void ws_produce(const WsMaps& maps,
                                           const Prod<float>& p,
                                           const WsGeo& g, int ring,
                                           uint32_t ring0, uint32_t bars) {
  constexpr uint32_t kBytes = (uint32_t)(BM + BN) * kWsBK * 4;
  int slot = 0;
  uint32_t phase = 0;
  for (int t = 2 * blockIdx.x + ring; t < g.tiles; t += 2 * gridDim.x) {
    const WsAt at = ws_at<op, BM, BN>(g, p, t);
    for (int s = 0; s < at.nst; ++s) {
      const int i = ring * kSlots + slot;
      const uint32_t full = bars + 8 * i;
      ws_wait(bars + 8 * (2 * kSlots + i), phase ^ 1);  // slot empty
      ws_expect_arrive(full, kBytes);
      const uint32_t a = ring0 + i * kStage, b = a + kBOff;
      const int k = s * kWsBK;
      if constexpr (op == kDw) {
        const int row = at.chunk * kDwChunkRows + k;
        if (at.h) {
          ws_load(a, &maps.a1, at.m0, row - p.B, full);
        } else {
          ws_load(a, &maps.a0, at.m0, row, full);
        }
        ws_load(b, &maps.b0, at.n0, row, full);
      } else {
        if (op == kGates && s >= g.sx) {
          const int kh = (s - g.sx) * kWsBK;
          ws_load(a, &maps.a1, kh, at.m0 - p.B, full);
          ws_load(b, &maps.b1, at.n0, kh, full);
        } else {
          ws_load(a, &maps.a0, k, at.m0, full);
          ws_load(b, &maps.b0, at.n0, k, full);
        }
      }
      if (++slot == kSlots) {
        slot = 0;
        phase ^= 1;
      }
    }
  }
}

// One k stage into the thread's TM x TN accumulators, k in order. A [m][k]
// (swizzled: row r's 16-byte chunk c lies at c ^ (r & 7), and r & 7 = tm &
// 7 for every row this thread reads) gives float4s over 4 k; dW's [k][m]
// float4s over 4 m.
// k quad kq (4 k) of a stage whose A is [m][k]: the rows' float4s and the
// 4 B rows' float4s over the quad, then per k TM x TN FFMA
template <int WM, int TM, int TN>
__device__ __forceinline__ void ws_fma_quad(float (&acc)[TM][TN],
                                            const float* at, const float* bt,
                                            int kq, int swz) {
  constexpr int WN = 128 / WM, BN = WN * TN;
  const int chunk = (kq ^ swz) * 4;
  float4 a[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
    a[i] = *reinterpret_cast<const float4*>(at + i * WM * kWsBK + chunk);
  float bq[4][TN];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < TN / 4; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(
          bt + (4 * kq + kk) * BN + 4 * WN * c);
      bq[kk][4 * c] = v.x;
      bq[kk][4 * c + 1] = v.y;
      bq[kk][4 * c + 2] = v.z;
      bq[kk][4 * c + 3] = v.w;
    }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float* b = bq[kk];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float av = kk == 0   ? a[i].x
                       : kk == 1 ? a[i].y
                       : kk == 2 ? a[i].z
                                 : a[i].w;
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
    }
  }
}

// One k stage into the thread's TM x TN accumulators, k in order. A [m][k]
// (swizzled: row r's 16-byte chunk c lies at c ^ (r & 7), and r & 7 = tm &
// 7 for every row this thread reads) gives float4s over 4 k; dW's [k][m]
// float4s over 4 m.
template <Op op, int WM, int TM, int TN, bool kUnrollAll>
__device__ __forceinline__ void ws_fma(float (&acc)[TM][TN],
                                       const float* as, const float* bs,
                                       int tm, int tn) {
  constexpr int WN = 128 / WM, BM = WM * TM, BN = WN * TN;
  const float* bt = bs + 4 * tn;
  if constexpr (op == kDw) {
    const float* at = as + 4 * tm;
#pragma unroll 4
    for (int k = 0; k < kWsBK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int c = 0; c < TM / 4; ++c) {
        const float4 v =
            *reinterpret_cast<const float4*>(at + k * BM + 4 * WM * c);
        a[4 * c] = v.x;
        a[4 * c + 1] = v.y;
        a[4 * c + 2] = v.z;
        a[4 * c + 3] = v.w;
      }
#pragma unroll
      for (int c = 0; c < TN / 4; ++c) {
        const float4 v =
            *reinterpret_cast<const float4*>(bt + k * BN + 4 * WN * c);
        b[4 * c] = v.x;
        b[4 * c + 1] = v.y;
        b[4 * c + 2] = v.z;
        b[4 * c + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  } else if constexpr (kUnrollAll) {
    const float* at = as + tm * kWsBK;
#pragma unroll
    for (int kq = 0; kq < kWsBK / 4; ++kq) {
      ws_fma_quad<WM, TM, TN>(acc, at, bt, kq, tm & 7);
    }
  } else {
    const float* at = as + tm * kWsBK;
#pragma unroll 2
    for (int kq = 0; kq < kWsBK / 4; ++kq) {
      ws_fma_quad<WM, TM, TN>(acc, at, bt, kq, tm & 7);
    }
  }
}

// Consumer group `ring`: every other tile of the block, each a k loop over
// its ring's slots (wait full, FFMA, release) and an epilogue of float4
// stores, the bias added last (0 for dx and dW: the element path's sums).
// dW's x-part first tile also sums its dgates columns in row order (the
// bias row).
template <Op op, int WM, int TM, int TN, int kSlots, bool kUnrollAll>
__device__ __forceinline__ void ws_consume(const Prod<float>& p,
                                           const WsGeo& g, int ring,
                                           const unsigned char* ring_base,
                                           uint32_t bars) {
  using S = WsTile<op, WM, TM, TN, kSlots, kUnrollAll>;
  constexpr int WN = S::WN, BM = S::BM, BN = S::BN;
  const int t = threadIdx.x & 127, tn = t % WN, tm = t / WN;
  const int G = 4 * p.H, N = op == kDx ? p.C : G;
  int slot = 0;
  uint32_t phase = 0;
  for (int tile = 2 * blockIdx.x + ring; tile < g.tiles;
       tile += 2 * gridDim.x) {
    const WsAt at = ws_at<op, BM, BN>(g, p, tile);
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    float bsum = 0.f;
    const bool sums = op == kDw && at.mt == 0 && t < BN;
    // the gates' bias, loaded during the last stage's FFMA
    float4 bias4[TN / 4];
#pragma unroll
    for (int c = 0; c < TN / 4; ++c) bias4[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < at.nst; ++s) {
      const int i = ring * kSlots + slot;
      ws_wait(bars + 8 * i, phase);
      const float* as =
          reinterpret_cast<const float*>(ring_base + i * S::kStage);
      const float* bs = as + S::kBOff / 4;
      if (sums) {
        for (int k = 0; k < kWsBK; ++k) bsum += bs[k * BN + t];
      }
      if ((op == kGates || op == kGatesX) && s == at.nst - 1) {
#pragma unroll
        for (int c = 0; c < TN / 4; ++c) {
          const int n = at.n0 + 4 * tn + 4 * WN * c;
          if (n < N) {
            bias4[c] = *reinterpret_cast<const float4*>(
                p.w + (long long)(p.C + p.H) * G + n);
          }
        }
      }
      ws_fma<op, WM, TM, TN, kUnrollAll>(acc, as, bs, tm, tn);
      __syncwarp();
      if ((threadIdx.x & 31) == 0) ws_arrive(bars + 8 * (2 * kSlots + i));
      if (++slot == kSlots) {
        slot = 0;
        phase ^= 1;
      }
    }
    if constexpr (op == kDw) {
      const int rows = at.h ? p.H : p.C;
      float* out = p.partials +
                   ((long long)at.chunk * (p.C + p.H + 1) + (at.h ? p.C : 0)) *
                       G;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = at.m0 + 4 * tm + 4 * WM * (i / 4) + (i % 4);
        if (m >= rows) continue;
#pragma unroll
        for (int c = 0; c < TN / 4; ++c) {
          const int n = at.n0 + 4 * tn + 4 * WN * c;
          if (n >= N) continue;
          *reinterpret_cast<float4*>(out + (long long)m * G + n) =
              make_float4(
              acc[i][4 * c] + 0.f, acc[i][4 * c + 1] + 0.f,
              acc[i][4 * c + 2] + 0.f, acc[i][4 * c + 3] + 0.f);
        }
      }
      if (sums && at.n0 + t < G) {
        p.partials[((long long)at.chunk * (p.C + p.H + 1) + p.C + p.H) * G +
                   at.n0 + t] = bsum;
      }
    } else {
      float bias[TN];
#pragma unroll
      for (int c = 0; c < TN / 4; ++c) {
        bias[4 * c] = bias4[c].x;
        bias[4 * c + 1] = bias4[c].y;
        bias[4 * c + 2] = bias4[c].z;
        bias[4 * c + 3] = bias4[c].w;
      }
      float* out = op == kDx ? p.dx : p.z;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = at.m0 + tm + WM * i;
        if (m >= p.TB) continue;
#pragma unroll
        for (int c = 0; c < TN / 4; ++c) {
          const int n = at.n0 + 4 * tn + 4 * WN * c;
          if (n >= N) continue;
          *reinterpret_cast<float4*>(out + (long long)m * N + n) =
              make_float4(
              acc[i][4 * c] + bias[4 * c], acc[i][4 * c + 1] + bias[4 * c + 1],
              acc[i][4 * c + 2] + bias[4 * c + 2],
              acc[i][4 * c + 3] + bias[4 * c + 3]);
        }
      }
    }
  }
}

template <Op op, int WM, int TM, int TN, int kSlots, bool kUnrollAll>
__global__ void __launch_bounds__(kWsThreads, 1)
    prod_f32_ws_kernel(const __grid_constant__ WsMaps maps,
                       const Prod<float> p, const WsGeo g) {
  using S = WsTile<op, WM, TM, TN, kSlots, kUnrollAll>;
  extern __shared__ __align__(1024) unsigned char ws_raw[];
  const uint32_t raw = smem_u32(ws_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t ring0 = raw + pad;  // TMA's swizzle wants 1024-byte slots
  const uint32_t bars = ring0 + 2 * kSlots * S::kStage;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * kSlots; ++i) {
      ws_bar_init(bars + 8 * i, 1);                 // full: the producer
      ws_bar_init(bars + 8 * (2 * kSlots + i), 4);  // empty: 4 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {  // the producer group: one lane a ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 || threadIdx.x == 32) {
      ws_produce<op, S::BM, S::BN, S::kStage, S::kBOff, kSlots>(
          maps, p, g, threadIdx.x >> 5, ring0, bars);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    ws_consume<op, WM, TM, TN, kSlots, kUnrollAll>(
        p, g, (threadIdx.x >> 7) - 1, ws_raw + pad, bars);
  }
}

// cuTensorMapEncodeTiled, from the CUDA driver at run time (no -lcuda);
// null where that driver does not give it
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(f)
               : nullptr;
  }();
  return fn;
}

// the map of a row-major (rows, cols) f32 matrix read in boxes of box_rows
// x box_cols, swizzled by 128 bytes (box_cols = 32) or not
inline bool ws_map(CUtensorMap* map, const float* base, long long rows,
                   int cols, int box_cols, int box_rows, bool swizzle) {
  const EncodeTiledFn encode = encode_tiled();
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <Op op, int WM, int TM, int TN, int kSlots = 2,
          bool kUnrollAll = false>
cudaError_t launch_ws(const Prod<float>& p, int chunks, cudaStream_t s) {
  using S = WsTile<op, WM, TM, TN, kSlots, kUnrollAll>;
  if (p.TB + S::BM > 0x7fffffffLL) return cudaErrorInvalidValue;  // int rows
  const int G = 4 * p.H, N = op == kDx ? p.C : G;
  WsGeo g = {};
  g.tiles_n = (N + S::BN - 1) / S::BN;
  g.sx = (p.C + kWsBK - 1) / kWsBK;
  if (op == kDw) {
    g.tiles_mx = (p.C + S::BM - 1) / S::BM;
    g.tiles_m = g.tiles_mx + (p.H + S::BM - 1) / S::BM;
    g.tiles = chunks * g.tiles_m * g.tiles_n;
    g.stages = kDwChunkRows / kWsBK;
  } else {
    g.tiles_m = (int)((p.TB + S::BM - 1) / S::BM);
    g.tiles = g.tiles_m * g.tiles_n;
    g.stages = op == kGates    ? g.sx + (p.H + kWsBK - 1) / kWsBK
               : op == kGatesX ? g.sx
                               : (G + kWsBK - 1) / kWsBK;
  }
  if (p.TB == 0 || g.tiles == 0) return cudaSuccess;
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  // h_{m-B}'s rows: those below TB - B (zero past them, as past TB)
  const long long hrows = p.TB - p.B > 0 ? p.TB - p.B : 1;
  WsMaps maps = {};
  bool ok;
  if (op == kGates || op == kGatesX) {
    ok = ws_map(&maps.a0, p.x, p.TB, p.C, kWsBK, S::BM, true) &&
         ws_map(&maps.b0, p.w, p.C, G, S::BN, kWsBK, false);
    if (op == kGates) {
      ok = ok && ws_map(&maps.a1, p.hs, hrows, p.H, kWsBK, S::BM, true) &&
           ws_map(&maps.b1, p.w + (long long)p.C * G, p.H, G, S::BN, kWsBK,
                  false);
    }
  } else if (op == kDx) {
    ok = ws_map(&maps.a0, p.dg, p.TB, G, kWsBK, S::BM, true) &&
         ws_map(&maps.b0, p.wxt, G, p.C, S::BN, kWsBK, false);
  } else {
    ok = ws_map(&maps.a0, p.x, p.TB, p.C, S::BM, kWsBK, false) &&
         ws_map(&maps.a1, p.hs, hrows, p.H, S::BM, kWsBK, false) &&
         ws_map(&maps.b0, p.dg, p.TB, G, S::BN, kWsBK, false);
  }
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = prod_f32_ws_kernel<op, WM, TM, TN, kSlots, kUnrollAll>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kWsThreads, S::kSmem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // persistent: a block an SM, or one a pair of tiles where fewer
  const int pairs = (g.tiles + 1) / 2, slots = sms * per_sm;
  const unsigned grid = (unsigned)(pairs < slots ? pairs : slots);
  kernel<<<grid, kWsThreads, S::kSmem, s>>>(maps, p, g);
  return cudaGetLastError();
}

// the tile side among 128, 96 and 160 (128 on a tie) that pads the widths
// n1 and n2 (dW's two parts; else n2 = 0) least
inline int ws_side(int n1, int n2) {
  auto padded = [&](int side) {
    return (n1 + side - 1) / side * side + (n2 + side - 1) / side * side;
  };
  const int sides[2] = {96, 160};
  int best = 128;
  for (int side : sides) {
    if (padded(side) < padded(best)) best = side;
  }
  return best;
}

// the Hopper kernel at the tile the op's widths ask for (the gates and Z_x:
// 128 x 128; dx: N = C; dW: M per part, C and H); two ring slots but for
// dW and dx's 128 x 128 tile, whose stages unroll whole: the settings
// tuned on an H100 at C = H = 160 and 256, within a few per cent of the
// others (PERF.md, chip_lstm_bwd_variants.py --products-split)
template <Op op>
cudaError_t launch_ws_op(const Prod<float>& p, int chunks, cudaStream_t s) {
  if constexpr (op == kGates || op == kGatesX) {
    return launch_ws<op, 16, 8, 16>(p, chunks, s);
  } else if constexpr (op == kDx) {
    switch (ws_side(p.C, 0)) {
      case 96: return launch_ws<op, 16, 8, 12>(p, chunks, s);
      case 160: return launch_ws<op, 16, 6, 20>(p, chunks, s);
      default: return launch_ws<op, 16, 8, 16, 3, true>(p, chunks, s);
    }
  } else {
    switch (ws_side(p.C, p.H)) {
      case 96: return launch_ws<op, 8, 12, 8, 3>(p, chunks, s);
      case 160: return launch_ws<op, 8, 20, 8, 3>(p, chunks, s);
      default: return launch_ws<op, 8, 16, 8, 3>(p, chunks, s);
    }
  }
}

int dw_chunks(long long TB) {
  return (int)((TB + kDwChunkRows - 1) / kDwChunkRows);
}

// 32-wide chunks a thread's float2s span along a dimension of size n: the
// fewest tiles of at most 128, then the narrowest tile that covers n
int chunks_for(long long n) {
  const long long tiles = (n + kTile - 1) / kTile;
  return (int)((n + 32 * tiles - 1) / (32 * tiles));
}

template <Op op, int MC, int NC>
cudaError_t launch_f32(const Prod<float>& p, int chunks, cudaStream_t s) {
  constexpr int kBM = 32 * MC, kBN = 32 * NC, kBK = 32;
  constexpr bool kAkm = op == kDw;
  constexpr int kASize = kAkm ? kBK * (kBM + 4) : kBM * (kBK + 4);
  constexpr size_t kSmem = (size_t)kStages * (kASize + kBK * (kBN + 4)) * 4;
  const long long M = op == kDw ? p.C + p.H : p.TB;
  const int N = op == kDx ? p.C : 4 * p.H;
  const dim3 grid((N + kBN - 1) / kBN, (unsigned)((M + kBM - 1) / kBM),
                  op == kDw ? chunks : 1);
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return cudaSuccess;
  auto kernel = wide_prod_f32_kernel<op, MC, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmem, s>>>(p);
  return cudaGetLastError();
}

// path: by shape (kByShape: the Hopper kernel where p.vec holds, else the
// element kernel), or one forced (lstm_prod.cu's entry); a forced Hopper
// path where p.vec does not hold is refused
enum Path { kByShape = 0, kPathWs = 1, kPathElement = 2 };

// the f32 product on its path; the element kernel with the tile its
// variable dimension asks for (dW: M = C + H, the gates: N = 4H, dx: N = C)
template <Op op>
cudaError_t launch_f32_op(const Prod<float>& p, int chunks, cudaStream_t s,
                          int path = kByShape) {
  if (path == kPathWs || (path == kByShape && p.vec)) {
    return p.vec ? launch_ws_op<op>(p, chunks, s) : cudaErrorInvalidValue;
  }
  const int c = chunks_for(op == kDw ? p.C + p.H : op == kDx ? p.C : 4 * p.H);
  if constexpr (op == kDw) {
    switch (c) {  // 96-row tiles spill their 6 x 8 thread tile: 64 instead
      case 1: return launch_f32<op, 1, 4>(p, chunks, s);
      case 2:
      case 3: return launch_f32<op, 2, 4>(p, chunks, s);
      default: return launch_f32<op, 4, 4>(p, chunks, s);
    }
  } else {
    switch (c) {
      case 1: return launch_f32<op, 4, 1>(p, chunks, s);
      case 2: return launch_f32<op, 4, 2>(p, chunks, s);
      case 3: return launch_f32<op, 4, 3>(p, chunks, s);
      default: return launch_f32<op, 4, 4>(p, chunks, s);
    }
  }
}

template <Op op>
cudaError_t launch_bf16(const Prod<bf16_bits>& p, int chunks,
                        cudaStream_t s) {
  constexpr int kBK = 64;
  constexpr bool kAkm = op == kDw;
  constexpr int kASize = kAkm ? kBK * (kTile + 8) : kTile * (kBK + 8);
  constexpr size_t kSmem =
      (size_t)kStages * (kASize + kBK * (kTile + 8)) * 2;
  const long long M = op == kDw ? p.C + p.H : p.TB;
  const int N = op == kDx ? p.C : 4 * p.H;
  const dim3 grid((N + kTile - 1) / kTile, (unsigned)((M + kTile - 1) / kTile),
                  op == kDw ? chunks : 1);
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return cudaSuccess;
  auto kernel = wide_prod_bf16_kernel<op>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmem, s>>>(p);
  return cudaGetLastError();
}

template <typename T, Op op>
cudaError_t launch_prod(const Prod<T>& p, int chunks, cudaStream_t s) {
  if constexpr (sizeof(T) == 4) {
    return launch_f32_op<op>(p, chunks, s);
  } else {
    return launch_bf16<op>(p, chunks, s);
  }
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

}  // namespace prod

}  // namespace
