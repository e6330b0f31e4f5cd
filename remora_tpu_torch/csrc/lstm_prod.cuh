// The LSTM backward's products off the serial chain, shared by the K3 legs
// that run them as launches of their own (lstm_wide_bwd.cu at C, H <= 128,
// lstm_general.cu above), f32 and bf16, sm_90a:
//   (a) the gate recompute Z = [x_t ; h_{t-1}] . W_aug[:C+H] + b for every
//       (t, row) at once, f32; its x part alone, Z_x = x_t . W_x + b (op
//       kGatesX, f32), is the general forward's W_h-ring path's
//       (lstm_general_cluster.cu);
//   (c) dx = dgates . W_x^T, rounded once, and dW_aug = [x ; h_{t-1}]^T .
//       dgates over fixed chunks of kDwChunkRows rows into f32 partials (the
//       bias row, the dgates column sums, taken by the chunk's first row
//       tile), which ordered_sum (mma_sm90.cuh) sums in chunk order: no
//       atomics, and a repeated call gives the same bits.
// Each product tiles M and N over the grid and loops over its K in stages,
// so it takes any C and H (the callers' shape checks bound them).
//
// Design (the plain twins are kernels/lstm.py's lstm_bwd_gates_reference
// and lstm_bwd_products_reference):
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
//     (128 x 128 tiles, 8 warps of 64 x 32, ldmatrix from padded tiles).

#pragma once

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
      bias[nt][e] = op == kGates && n < N
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
          float* out = op == kGates
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

// the f32 product with the tile its variable dimension asks for (dW: M = C +
// H, the gates: N = 4H, dx: N = C)
template <Op op>
cudaError_t launch_f32_op(const Prod<float>& p, int chunks, cudaStream_t s) {
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
