// K3's bf16 leg on Hopper (sm_90a): the training LSTM backward as three
// tensor-core kernels and an ordered sum.
//
// Replaces, for bf16, remora_tpu/kernels/pallas_lstm.py::_bwd_kernel
// (launched by _bwd_call): the reverse-time backward of a single-layer LSTM
// over x (T, B, C) that recomputes the gates from the saved h and c, writes
// dx and sums dW_aug = sum_t [x_t ; h_{t-1} ; 1]^T . dgates_t. The f32 leg
// is lstm_bwd_f32.cu.
//
// Only a sixth of the work depends on the carry. The gates need only the
// saved x and hs, and dx and dW need only dgates once they are written; the
// serial chain is dh_t -> gate cotangents -> dgates_t (rounded to bf16) ->
// dh_{t-1} = dgates_t . W_h^T. So the backward runs as three launches (the
// plain twins in kernels/lstm.py: lstm_bwd_gates_reference,
// lstm_bwd_recurrence_reference, lstm_bwd_products_reference):
//
//   (a) lstm_bwd_gates_kernel: Z = [x_t ; h_{t-1}] . W_aug[:C+H] + b for
//       every (t, row) at once, M = T*B rows, K = C+H, N = 4H, on
//       mma.sync.m16n8k16
//       (bf16 operands, f32 accumulators); Z leaves in f32. Block: 128 rows
//       (8 warps x m16) x 128 gate columns; the XH tile ([x_m ; h_{m-B}],
//       zero for m < B) and the W_aug slice staged once by cp.async.
//   (b) lstm_bwd_recurrence_kernel, the only serial part: one block owns 16
//       batch rows (one m16 tile) and walks t = T-1 ... 0. Warp w owns hidden
//       units 8w .. 8w+7. The k order of dh = dgates . W_h^T is permuted so
//       that the warp's 32 gate columns (i, f | g, o of its 8 units) are two
//       k16 tiles whose A fragments are exactly the (row, unit) elements the
//       lane computes: lane (g, q) does the gate math of rows g, g+8 and
//       units 8w+2q, 8w+2q+1, packs its dgates into A fragments in
//       registers, and runs 2 x 8 mma.sync against W_h^T's B fragments,
//       which it holds in 32 registers for the whole walk. The mma's C
//       fragment of unit tile w is again the lane's own elements, so after
//       one block barrier a step the warp-partial dh (8 partials, summed in
//       warp order) lands where the next step needs it. Each thread stages
//       its own Z, c_t, c_{t-1} and dh_t four steps ahead with cp.async
//       into a private slot, so no barrier orders the inputs and no global
//       load sits on the chain; the activations of step t-1 are computed
//       after step t's mma is issued. dgates leave as (T, B, 4H) bf16.
//   (c) lstm_bwd_dx_kernel: dx = dgates . W_x^T (K = 4H, N = C), rounded to
//       bf16 once; lstm_bwd_dw_kernel: dW_aug = [x ; h_{t-1} ; 1]^T . dgates
//       (M = C+H+1 padded to m16 tiles, N = 4H, K = T*B), the bias row the
//       ones column of the staged XH. lstm_bwd_dw_kernel splits K over fixed
//       row chunks into f32 partials that ordered_sum (mma_sm90.cuh) sums in
//       chunk order: no float atomics, and two calls give the same bits.
//
// Numerics are lstm_bwd_reference's and the JAX kernel's: gates from f32
// sums of bf16 products; dgates rounded to bf16 before every product (dh,
// dx and dW); dh and dc carried in f32; dx rounded once; dW in f32. The
// recurrence keeps the twin's product order (no FMA contraction there).
//
// Bounds at the main path's shape (T = 124, B = 2048, C = H = 64; H100 SXM,
// 989 TFLOP/s bf16, 3.35 TB/s): the function reads x, hs, cs, dhs and W and
// writes dx and dW, 179.5 MB (0.054 ms), for 50 GFLOP (0.05 ms). This plan
// trades bytes for a short chain and moves about 880 MB: (a) writes Z in
// f32 (260 MB), (b) reads it with c and dh (358 MB) and writes dgates (130
// MB), and (c) reads dgates twice. Fusing (a) into (b), each block
// recomputing its Z_t a step ahead, is the next cut. The chain of (b) is a
// few hundred cycles a step; its 1024 elements' activations (3 sigmoid + 2
// tanh each) are the heaviest step work, between one barrier and the next.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxH = 8 * kWarps;  // (b): 8 hidden units a warp
constexpr int kMaxK = 128;         // C + H: (a)'s staged depth, dW's rows
constexpr int kTileM = 16 * kWarps;  // rows a block in (a) and dx
constexpr int kNB = 128;           // gate columns a block in (a) and dW
constexpr int kMaxNT = 16;         // n8 tiles a warp in (a) and dx
constexpr int kRecRows = 16;       // batch rows a block in (b)
constexpr int kRecStages = 4;      // (b)'s private cp.async slots
constexpr int kRecZ = 8;           // float2 of Z a thread a step
constexpr int kRecV = 6;           // bf16 pairs (c_t, c_{t-1}, dh_t) a step
constexpr int kDwRows = 32;        // dW: K rows a stage (two k16 steps)
constexpr int kDwStages = 3;
constexpr int kDwMT = (kMaxK + 1 + 15) / 16;  // dW's m16 tiles at most
constexpr int kDwChunks = 128;     // dW's K chunks wanted
constexpr size_t kSmemMax = 232448;  // 227 KB a block can use
constexpr bf16_bits kOne = 0x3F80;   // bf16 1.0

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__device__ __forceinline__ float bf(bf16_bits v) {
  return __uint_as_float((uint32_t)v << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

// 8 bytes, zero fill where !valid
__device__ __forceinline__ void cp_async8z(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

// Rows [m0, m0 + n_rows) of XH = [x_m ; h_{m-B} (zero for m < B) ; 1 if
// ones ; zeros] into dst[r][0 .. width), width a multiple of 8; rows >= M
// are zero. x is (M, C) and hs (M, H) as (T, B, .) tensors are. kVec:
// 16-byte cp.async (C and H multiples of 8, x and hs 16-byte aligned).
template <bool kVec>
__device__ void stage_xh(bf16_bits* dst, int ld, const bf16_bits* x,
                         const bf16_bits* hs, long long m0, int n_rows,
                         long long M, int B, int C, int H, int width,
                         bool ones) {
  const int K = C + H;
  if (kVec) {
    const int chunks = width / 8;
    for (int e = threadIdx.x; e < n_rows * chunks; e += kThreads) {
      const int r = e / chunks, k = (e - r * chunks) * 8;
      const long long m = m0 + r;
      const bool row = m < M;
      bf16_bits* d = dst + r * ld + k;
      if (k < C) {
        cp_async16z(d, row ? x + m * C + k : x, row);
      } else if (k < K) {
        const bool v = row && m >= B;
        cp_async16z(d, v ? hs + (m - B) * H + (k - C) : hs, v);
      } else {
        uint4 c = make_uint4(0, 0, 0, 0);
        if (ones && row && k == K) c.x = kOne;
        *reinterpret_cast<uint4*>(d) = c;
      }
    }
  } else {
    for (int e = threadIdx.x; e < n_rows * width; e += kThreads) {
      const int r = e / width, k = e - r * width;
      const long long m = m0 + r;
      bf16_bits v = 0;
      if (m < M) {
        if (k < C) {
          v = x[m * C + k];
        } else if (k < K) {
          if (m >= B) v = hs[(m - B) * H + (k - C)];
        } else if (ones && k == K) {
          v = kOne;
        }
      }
      dst[r * ld + k] = v;
    }
  }
}

// dst[r][c] = src[(r0 + r) * ld + c0 + c] for r0 + r < r_end and c0 + c <
// c_end, else 0; r < n_rows, c < width (a multiple of 8). kVec: 16-byte
// cp.async (ld, c0 and c_end multiples of 8, src 16-byte aligned).
template <bool kVec>
__device__ void stage_rows(bf16_bits* dst, int dst_ld, const bf16_bits* src,
                           long long ld, long long r0, long long r_end,
                           int n_rows, int c0, int c_end, int width) {
  if (kVec) {
    const int chunks = width / 8;
    for (int e = threadIdx.x; e < n_rows * chunks; e += kThreads) {
      const int r = e / chunks, c = (e - r * chunks) * 8;
      const bool valid = r0 + r < r_end && c0 + c < c_end;
      cp_async16z(dst + r * dst_ld + c,
                  valid ? src + (r0 + r) * ld + c0 + c : src, valid);
    }
  } else {
    for (int e = threadIdx.x; e < n_rows * width; e += kThreads) {
      const int r = e / width, c = e - r * width;
      const bool valid = r0 + r < r_end && c0 + c < c_end;
      dst[r * dst_ld + c] = valid ? src[(r0 + r) * ld + c0 + c] : 0;
    }
  }
}

// ------------------------- (a) the gate recompute -------------------------

struct GatesCfg {
  int kp;     // C + H rounded up to 16: the staged depth
  int nb;     // gate columns a block (a multiple of 16, <= kNB)
  int n_col;  // blocks across the 4H gate columns
  long long row_tiles;
  size_t smem;
};

GatesCfg gates_cfg(long long M, int C, int H) {
  GatesCfg c;
  c.kp = round_up(C + H, 16);
  const int gp = round_up(4 * H, 16);
  c.nb = gp < kNB ? gp : kNB;
  c.n_col = (gp + c.nb - 1) / c.nb;
  c.row_tiles = (M + kTileM - 1) / kTileM;
  c.smem = ((size_t)kTileM * (c.kp + 8) + (size_t)c.kp * (c.nb + 8)) * 2;
  return c;
}

// Block (row tile, column tile), the column tile fastest so that the blocks
// that share an XH tile run together. Warp w computes rows 16w .. 16w+15 of
// the tile and all nb columns: A from the XH tile ([row][k], ldmatrix), B
// from the W slice ([k][n], ldmatrix.trans).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    lstm_bwd_gates_kernel(const bf16_bits* __restrict__ x,
                 const bf16_bits* __restrict__ hs,
                 const bf16_bits* __restrict__ w_aug, float* __restrict__ z,
                 long long M, int B, int C, int H, GatesCfg cfg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = 4 * H, K = C + H, kp = cfg.kp, nb = cfg.nb;
  const int lda = kp + 8, ldb = nb + 8;
  bf16_bits* sa = reinterpret_cast<bf16_bits*>(smem_raw);
  bf16_bits* sb = sa + kTileM * lda;
  const int n0 = (blockIdx.x % cfg.n_col) * nb;
  const long long m0 = (long long)(blockIdx.x / cfg.n_col) * kTileM;
  stage_xh<kVec>(sa, lda, x, hs, m0, kTileM, M, B, C, H, kp, false);
  stage_rows<kVec>(sb, ldb, w_aug, G, 0, K, kp, n0, G, nb);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = nb / 8;
  float acc[kMaxNT][4];
#pragma unroll
  for (int j = 0; j < kMaxNT; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;
  for (int ks = 0; ks < kp / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, smem_u32(sa + (warp * 16 + (lane & 15)) * lda + ks * 16 +
                        (lane >> 4) * 8));
#pragma unroll
    for (int j = 0; j < kMaxNT; j += 2) {
      if (j < nt) {
        uint32_t bb[4];
        ldsm_x4_t(bb, smem_u32(sb +
                               (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   ldb +
                               j * 8 + (lane >> 4) * 8));
        mma_16816(acc[j], a, bb);
        mma_16816(acc[j + 1], a, bb + 2);
      }
    }
  }

  // C fragment (j, v): row 16 warp + g + 8 (v / 2), column 8 j + 2 q + v % 2
  const int g = lane >> 2, q = lane & 3;
  const bf16_bits* bias = w_aug + (long long)K * G;
#pragma unroll
  for (int j = 0; j < kMaxNT; ++j) {
    const int col = n0 + 8 * j + 2 * q;  // even; G is a multiple of 4
    if (j >= nt || col >= G) continue;
    const float b0 = bf(bias[col]), b1 = bf(bias[col + 1]);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const long long m = m0 + warp * 16 + g + 8 * s;
      if (m < M) {
        *reinterpret_cast<float2*>(z + m * G + col) =
            make_float2(acc[j][2 * s] + b0, acc[j][2 * s + 1] + b1);
      }
    }
  }
}

// ----------------------- (b) the reverse recurrence -----------------------

// (b)'s shared memory: kRecStages private slots of kRecZ float2 and kRecV
// bf16 pairs a thread (item-major, threads contiguous), then the warp
// partials of dh, two buffers of [kWarps][kRecRows][hps] f32 (hps = 8 mod
// 32, so the lanes' float2 accesses hit distinct banks).
struct RecCfg {
  int hps;
  size_t z_off, v_off, part_off, smem;
};

RecCfg rec_cfg(int H) {
  RecCfg c;
  c.hps = round_up(round_up(H, 8), 32) + 8;
  c.z_off = 0;
  c.v_off = c.z_off + (size_t)kRecStages * kRecZ * kThreads * 8;
  c.part_off = c.v_off + (size_t)kRecStages * kRecV * kThreads * 4;
  c.smem = c.part_off + (size_t)2 * kWarps * kRecRows * c.hps * 4;
  return c;
}

// The carry-independent inputs of one step, per element (row g + 8 s, unit
// u + p) of the lane: the gate activations, tanh(c_t), c_{t-1} and dh_t.
struct StepIn {
  float i[2][2], f[2][2], g[2][2], o[2][2], tc[2][2], cp[2][2], dh[2][2];
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_bwd_recurrence_kernel(const float* __restrict__ z,
                      const bf16_bits* __restrict__ cs,
                      const bf16_bits* __restrict__ dhs,
                      const bf16_bits* __restrict__ w_aug,
                      bf16_bits* __restrict__ dg, int T, int B, int C, int H,
                      RecCfg cfg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* zst = reinterpret_cast<float2*>(smem_raw + cfg.z_off);
  uint32_t* vst = reinterpret_cast<uint32_t*>(smem_raw + cfg.v_off);
  float* part = reinterpret_cast<float*>(smem_raw + cfg.part_off);
  const int G = 4 * H, hps = cfg.hps;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int nw = (H + 7) / 8;  // warps with hidden units
  const bool active = warp < nw;
  const int u = 8 * warp + 2 * q;  // the lane's units u, u + 1
  const int b0 = blockIdx.x * kRecRows;
  bool ok[2][2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int p = 0; p < 2; ++p)
      ok[s][p] = active && b0 + g + 8 * s < B && u + p < H;

  // B fragments of W_h^T for k tiles kt (gates 2kt | 2kt + 1 of the warp's
  // units) and dh tiles j (units 8j .. 8j + 7): W_aug[C + 8j + g][gate * H +
  // u + {0, 1}], zero past H
  uint32_t wb[2][kMaxH / 8][2];
#pragma unroll
  for (int kt = 0; kt < 2; ++kt)
#pragma unroll
    for (int j = 0; j < kMaxH / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 8 * j + g, gate = 2 * kt + h;
        uint32_t v = 0;
        if (active && n < H) {
          const bf16_bits* row = w_aug + (long long)(C + n) * G + gate * H;
          if (u < H) v = row[u];
          if (u + 1 < H) v |= (uint32_t)row[u + 1] << 16;
        }
        wb[kt][j][h] = v;
      }

  // step t's inputs into slot t % kRecStages (nothing for t < 0)
  auto issue = [&](int t) {
    if (t < 0) return;
    const int slot = t % kRecStages;
    float2* zs = zst + (size_t)slot * kRecZ * kThreads + tid;
    uint32_t* vs = vst + (size_t)slot * kRecV * kThreads + tid;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const long long row = (long long)t * B + b0 + g + 8 * s;
      const long long row_p = row - B;  // c_{t-1}
      if (kVec) {  // H even: u, u + 1 both valid or both not
        const bool v = ok[s][0];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) {
          cp_async8z(zs + (gate * 2 + s) * kThreads,
                     v ? z + row * G + gate * H + u : z, v);
        }
        cp_async4(vs + s * kThreads, v ? cs + row * H + u : cs, v);
        const bool vp = v && t > 0;
        cp_async4(vs + (2 + s) * kThreads, vp ? cs + row_p * H + u : cs, vp);
        cp_async4(vs + (4 + s) * kThreads, v ? dhs + row * H + u : dhs, v);
      } else {
        float zv[4][2];
        bf16_bits cv[3][2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const bool v = ok[s][p];
#pragma unroll
          for (int gate = 0; gate < 4; ++gate) {
            zv[gate][p] = v ? z[row * G + gate * H + u + p] : 0.f;
          }
          cv[0][p] = v ? cs[row * H + u + p] : 0;
          cv[1][p] = v && t > 0 ? cs[row_p * H + u + p] : 0;
          cv[2][p] = v ? dhs[row * H + u + p] : 0;
        }
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) {
          zs[(gate * 2 + s) * kThreads] =
              make_float2(zv[gate][0], zv[gate][1]);
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          vs[(2 * k + s) * kThreads] =
              (uint32_t)cv[k][0] | ((uint32_t)cv[k][1] << 16);
        }
      }
    }
  };

  // the activations of step t from its slot (this thread's own copies)
  auto prepare = [&](int t, StepIn& in) {
    const int slot = t % kRecStages;
    const float2* zs = zst + (size_t)slot * kRecZ * kThreads + tid;
    const uint32_t* vs = vst + (size_t)slot * kRecV * kThreads + tid;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float2 zi = zs[(0 + s) * kThreads], zf = zs[(2 + s) * kThreads];
      const float2 zg = zs[(4 + s) * kThreads], zo = zs[(6 + s) * kThreads];
      const uint32_t c = vs[s * kThreads], cp = vs[(2 + s) * kThreads];
      const uint32_t dh = vs[(4 + s) * kThreads];
      const float zis[2] = {zi.x, zi.y}, zfs[2] = {zf.x, zf.y};
      const float zgs[2] = {zg.x, zg.y}, zos[2] = {zo.x, zo.y};
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        in.i[s][p] = sigmoid(zis[p]);
        in.f[s][p] = sigmoid(zfs[p]);
        in.g[s][p] = tanhf(zgs[p]);
        in.o[s][p] = sigmoid(zos[p]);
        in.tc[s][p] = tanhf(bf((bf16_bits)(p ? c >> 16 : c & 0xFFFF)));
        in.cp[s][p] = bf((bf16_bits)(p ? cp >> 16 : cp & 0xFFFF));
        in.dh[s][p] = bf((bf16_bits)(p ? dh >> 16 : dh & 0xFFFF));
      }
    }
  };

  for (int k = 0; k < kRecStages; ++k) {
    issue(T - 1 - k);
    cp_async_commit();
  }
  StepIn in;
  if (T > 0) {
    cp_async_wait<kRecStages - 1>();
    prepare(T - 1, in);
    issue(T - 1 - kRecStages);
    cp_async_commit();
  }

  float dhc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // dh carry (f32)
  float dcc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // dc carry (f32)
  for (int t = T - 1; t >= 0; --t) {
    if (t < T - 1) {
      __syncthreads();  // the warp partials of dh_t are written
      const float* pb = part + (size_t)((t + 1) & 1) * kWarps * kRecRows * hps;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        float2 sum = make_float2(0.f, 0.f);
        for (int w = 0; w < nw; ++w) {
          const float2 v = *reinterpret_cast<const float2*>(
              pb + ((size_t)w * kRecRows + g + 8 * s) * hps + u);
          sum.x = __fadd_rn(sum.x, v.x);
          sum.y = __fadd_rn(sum.y, v.y);
        }
        dhc[s][0] = sum.x;
        dhc[s][1] = sum.y;
      }
    }

    // gate cotangents in the twin's product order; dgates rounded once
    uint32_t a[2][4];  // A fragments: k tile 0 = i | f, 1 = g | o
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      float d[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float ig = in.i[s][p], fg = in.f[s][p], gg = in.g[s][p];
        const float og = in.o[s][p], tc = in.tc[s][p];
        const float dh = __fadd_rn(in.dh[s][p], dhc[s][p]);
        const float dc = __fadd_rn(
            dcc[s][p],
            __fmul_rn(__fmul_rn(dh, og), __fsub_rn(1.f, __fmul_rn(tc, tc))));
        const float di = __fmul_rn(__fmul_rn(__fmul_rn(dc, gg), ig),
                                   __fsub_rn(1.f, ig));
        const float df = __fmul_rn(__fmul_rn(__fmul_rn(dc, in.cp[s][p]), fg),
                                   __fsub_rn(1.f, fg));
        const float dgg =
            __fmul_rn(__fmul_rn(dc, ig), __fsub_rn(1.f, __fmul_rn(gg, gg)));
        const float dgo = __fmul_rn(__fmul_rn(__fmul_rn(dh, tc), og),
                                    __fsub_rn(1.f, og));
        const bool v = ok[s][p];
        d[0][p] = v ? di : 0.f;
        d[1][p] = v ? df : 0.f;
        d[2][p] = v ? dgg : 0.f;
        d[3][p] = v ? dgo : 0.f;
        dcc[s][p] = v ? __fmul_rn(dc, fg) : 0.f;
      }
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        a[gate >> 1][(gate & 1) * 2 + s] = pack_bf16(d[gate][0], d[gate][1]);
      }
    }

    // dgates_t to global memory, (T, B, 4H) bf16
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (!ok[s][0]) continue;
      const long long row = (long long)t * B + b0 + g + 8 * s;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        const uint32_t v = a[gate >> 1][(gate & 1) * 2 + s];
        bf16_bits* dst = dg + row * G + gate * H + u;
        if (kVec) {
          *reinterpret_cast<uint32_t*>(dst) = v;
        } else {
          dst[0] = (bf16_bits)(v & 0xFFFF);
          if (ok[s][1]) dst[1] = (bf16_bits)(v >> 16);
        }
      }
    }

    if (t == 0) break;

    // dh_{t-1}, this warp's k slice: partials of every unit tile j
    if (active) {
      float* pb = part + (size_t)(t & 1) * kWarps * kRecRows * hps +
                  (size_t)warp * kRecRows * hps;
#pragma unroll
      for (int j = 0; j < kMaxH / 8; ++j) {
        if (j < nw) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          mma_16816(acc, a[0], wb[0][j]);
          mma_16816(acc, a[1], wb[1][j]);
          *reinterpret_cast<float2*>(pb + (size_t)g * hps + 8 * j + 2 * q) =
              make_float2(acc[0], acc[1]);
          *reinterpret_cast<float2*>(pb + (size_t)(g + 8) * hps + 8 * j +
                                     2 * q) = make_float2(acc[2], acc[3]);
        }
      }
    }

    // step t-1's activations while the partials travel; then refill its slot
    cp_async_wait<kRecStages - 1>();
    prepare(t - 1, in);
    issue(t - 1 - kRecStages);
    cp_async_commit();
  }
}

// ----------------------- (c) the products off the chain ------------------

struct DxCfg {
  int gp, cp;
  long long row_tiles;
  size_t smem;
};

DxCfg dx_cfg(long long M, int C, int H) {
  DxCfg c;
  c.gp = round_up(4 * H, 16);
  c.cp = round_up(C, 16);
  c.row_tiles = (M + kTileM - 1) / kTileM;
  c.smem = (size_t)(kTileM + c.cp) * (c.gp + 8) * 2;
  return c;
}

// dx = dgates . W_x^T: block of 128 rows, warp w rows 16w .. 16w+15 and all
// C columns; A = dgates [row][gate] (ldmatrix), B = W_aug[:C] [c][gate]
// (ldmatrix: the col-major B of mma)
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    lstm_bwd_dx_kernel(const bf16_bits* __restrict__ dg,
              const bf16_bits* __restrict__ w_aug, bf16_bits* __restrict__ dx,
              long long M, int C, int H, DxCfg cfg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = 4 * H, gp = cfg.gp, ld = gp + 8;
  bf16_bits* sa = reinterpret_cast<bf16_bits*>(smem_raw);
  bf16_bits* sb = sa + kTileM * ld;
  const long long m0 = (long long)blockIdx.x * kTileM;
  stage_rows<kVec>(sa, ld, dg, G, m0, M, kTileM, 0, G, gp);
  stage_rows<kVec>(sb, ld, w_aug, G, 0, C, cfg.cp, 0, G, gp);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = cfg.cp / 8;
  float acc[kMaxNT][4];
#pragma unroll
  for (int j = 0; j < kMaxNT; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;
  for (int ks = 0; ks < gp / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, smem_u32(sa + (warp * 16 + (lane & 15)) * ld + ks * 16 +
                        (lane >> 4) * 8));
#pragma unroll
    for (int j = 0; j < kMaxNT; j += 2) {
      if (j < nt) {
        uint32_t bb[4];
        ldsm_x4(bb, smem_u32(sb +
                             (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                             ks * 16 + ((lane >> 3) & 1) * 8));
        mma_16816(acc[j], a, bb);
        mma_16816(acc[j + 1], a, bb + 2);
      }
    }
  }

  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < kMaxNT; ++j) {
    const int c = 8 * j + 2 * q;
    if (j >= nt || c >= C) continue;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const long long m = m0 + warp * 16 + g + 8 * s;
      if (m >= M) continue;
      const uint32_t v = pack_bf16(acc[j][2 * s], acc[j][2 * s + 1]);
      bf16_bits* dst = dx + m * C + c;
      if (C % 2 == 0) {
        *reinterpret_cast<uint32_t*>(dst) = v;
      } else {
        dst[0] = (bf16_bits)(v & 0xFFFF);
        if (c + 1 < C) dst[1] = (bf16_bits)(v >> 16);
      }
    }
  }
}

struct DwCfg {
  int ka;      // C + H + 1 rounded up to 16: dW's rows on the tensor cores
  int nb;      // gate columns a block
  int n_col;   // blocks across the gate columns
  int chunks;  // K chunks (rows of T*B), each its own f32 partial
  long long per_chunk;  // rows a chunk, a multiple of kDwRows
  int lda, ldb, stage;
  size_t smem;
};

DwCfg dw_cfg(long long M, int C, int H) {
  DwCfg c;
  c.ka = round_up(C + H + 1, 16);
  const int gp = round_up(4 * H, 16);
  c.nb = gp < kNB ? gp : kNB;
  c.n_col = (gp + c.nb - 1) / c.nb;
  long long per = (M + kDwChunks - 1) / kDwChunks;
  per = (per + kDwRows - 1) / kDwRows * kDwRows;
  c.per_chunk = per < kDwRows ? kDwRows : per;
  c.chunks = (int)((M + c.per_chunk - 1) / c.per_chunk);
  c.lda = c.ka + 8;
  c.ldb = c.nb + 8;
  c.stage = kDwRows * (c.lda + c.ldb);
  c.smem = (size_t)kDwStages * c.stage * 2;
  return c;
}

// dW partial of one K chunk and one gate column tile: warp w owns gate
// columns 16w .. 16w+15 of the tile and every m16 tile of [x ; h ; 1]'s
// C + H + 1 rows. Each stage holds 32 rows of XH ([row][feature]) and of
// dgates ([row][gate]); A = XH^T and B = dgates are both read with
// ldmatrix.trans, the next two stages' copies in flight.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    lstm_bwd_dw_kernel(const bf16_bits* __restrict__ x,
              const bf16_bits* __restrict__ hs,
              const bf16_bits* __restrict__ dg, float* __restrict__ partials,
              long long M, int B, int C, int H, DwCfg cfg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_bits* stages = reinterpret_cast<bf16_bits*>(smem_raw);
  const int G = 4 * H, K = C + H, lda = cfg.lda, ldb = cfg.ldb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x % cfg.n_col) * cfg.nb;
  const int chunk = blockIdx.x / cfg.n_col;
  const long long r_lo = (long long)chunk * cfg.per_chunk;
  const long long r_hi =
      r_lo + cfg.per_chunk < M ? r_lo + cfg.per_chunk : M;
  const int n_steps = (int)((r_hi - r_lo + kDwRows - 1) / kDwRows);
  const int mt_n = cfg.ka / 16;
  const bool busy = 16 * warp < cfg.nb;

  auto issue = [&](int step, int s) {
    bf16_bits* sx = stages + (size_t)s * cfg.stage;
    bf16_bits* sg = sx + kDwRows * lda;
    const long long m0 = r_lo + (long long)step * kDwRows;
    stage_xh<kVec>(sx, lda, x, hs, m0, kDwRows, M, B, C, H, cfg.ka, true);
    stage_rows<kVec>(sg, ldb, dg, G, m0, M, kDwRows, n0, G, cfg.nb);
  };

  float acc[kDwMT][2][4];
#pragma unroll
  for (int mt = 0; mt < kDwMT; ++mt)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mt][n][v] = 0.f;

  for (int s = 0; s < kDwStages - 1; ++s) {
    if (s < n_steps) issue(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    const int ahead = step + kDwStages - 1;
    if (ahead < n_steps) issue(ahead, ahead % kDwStages);
    cp_async_commit();
    cp_async_wait<kDwStages - 1>();  // step's group has landed
    __syncthreads();
    const bf16_bits* sx = stages + (size_t)(step % kDwStages) * cfg.stage;
    const bf16_bits* sg = sx + kDwRows * lda;
    if (busy) {
#pragma unroll
      for (int ks = 0; ks < kDwRows / 16; ++ks) {
        uint32_t bb[4];
        ldsm_x4_t(bb, smem_u32(sg +
                               (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   ldb +
                               16 * warp + (lane >> 4) * 8));
#pragma unroll
        for (int mt = 0; mt < kDwMT; ++mt) {
          if (mt < mt_n) {
            uint32_t a[4];
            ldsm_x4_t(a, smem_u32(sx +
                                  (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                      lda +
                                  mt * 16 + ((lane >> 3) & 1) * 8));
            mma_16816(acc[mt][0], a, bb);
            mma_16816(acc[mt][1], a, bb + 2);
          }
        }
      }
    }
    __syncthreads();  // stage step % kDwStages is free for step + kDwStages
  }

  // partials[chunk][row][gate], rows 0 .. K (K: the bias row)
  float* part = partials + (size_t)chunk * (K + 1) * G;
  const int g = lane >> 2, q = lane & 3;
  if (!busy) return;
#pragma unroll
  for (int mt = 0; mt < kDwMT; ++mt) {
    if (mt >= mt_n) continue;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = n0 + 16 * warp + 8 * n + 2 * q;
      if (col >= G) continue;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int r = mt * 16 + g + 8 * s;
        if (r <= K) {
          *reinterpret_cast<float2*>(part + (size_t)r * G + col) =
              make_float2(acc[mt][n][2 * s], acc[mt][n][2 * s + 1]);
        }
      }
    }
  }
}

bool fits(int C, int H) {
  return C >= 1 && H >= 1 && H <= kMaxH && C + H <= kMaxK;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Each launcher returns the cudaError_t of its launches (0 = launched).
// Tensors are contiguous: x (T, B, C), hs, cs, dhs (T, B, H) and w_aug (C +
// H + 1, 4H) in bf16; z (T, B, 4H) f32; dg (T, B, 4H) bf16.

// (a) z = [x_t ; h_{t-1}] . W_aug[:C+H] + b
int lstm_bwd_mma_gates(const void* x, const void* hs, const void* w_aug,
                       void* z, int T, int B, int C, int H, void* stream) {
  if (T < 0 || B < 1 || !fits(C, H)) return (int)cudaErrorInvalidValue;
  const long long M = (long long)T * B;
  if (M == 0) return 0;
  const GatesCfg cfg = gates_cfg(M, C, H);
  const bool vec = C % 8 == 0 && H % 8 == 0 && aligned16(x) &&
                   aligned16(hs) && aligned16(w_aug);
  auto kernel =
      vec ? lstm_bwd_gates_kernel<true> : lstm_bwd_gates_kernel<false>;
  cudaError_t err = set_smem(kernel, cfg.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(cfg.row_tiles * cfg.n_col), kThreads, cfg.smem,
           (cudaStream_t)stream>>>(
      static_cast<const bf16_bits*>(x), static_cast<const bf16_bits*>(hs),
      static_cast<const bf16_bits*>(w_aug), static_cast<float*>(z), M, B, C,
      H, cfg);
  return (int)cudaGetLastError();
}

// (b) dg from z, the saved c and the hidden-state cotangents
int lstm_bwd_mma_recurrence(const void* z, const void* cs, const void* dhs,
                            const void* w_aug, void* dg, int T, int B, int C,
                            int H, void* stream) {
  if (T < 0 || B < 1 || !fits(C, H)) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const RecCfg cfg = rec_cfg(H);
  const bool vec = H % 2 == 0 && aligned16(z) && aligned16(cs) &&
                   aligned16(dhs) && aligned16(dg);
  auto kernel = vec ? lstm_bwd_recurrence_kernel<true>
                    : lstm_bwd_recurrence_kernel<false>;
  cudaError_t err = set_smem(kernel, cfg.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(B + kRecRows - 1) / kRecRows, kThreads, cfg.smem,
           (cudaStream_t)stream>>>(
      static_cast<const float*>(z), static_cast<const bf16_bits*>(cs),
      static_cast<const bf16_bits*>(dhs),
      static_cast<const bf16_bits*>(w_aug), static_cast<bf16_bits*>(dg), T,
      B, C, H, cfg);
  return (int)cudaGetLastError();
}

// (c) dx (T, B, C) bf16 and dw (C + H + 1, 4H) f32 from dg; partials:
// (lstm_bwd_mma_chunks(T, B, C, H), C + H + 1, 4H) f32 scratch
int lstm_bwd_mma_products(const void* x, const void* hs, const void* w_aug,
                          const void* dg, void* dx, void* partials, void* dw,
                          int T, int B, int C, int H, void* stream) {
  if (T < 0 || B < 1 || !fits(C, H)) return (int)cudaErrorInvalidValue;
  const long long M = (long long)T * B;
  const int n_elems = (C + H + 1) * 4 * H;
  int chunks = 0;
  if (M > 0) {
    const DxCfg xc = dx_cfg(M, C, H);
    const bool vec_g = H % 2 == 0 && aligned16(dg) && aligned16(w_aug);
    auto kx =
        vec_g ? lstm_bwd_dx_kernel<true> : lstm_bwd_dx_kernel<false>;
    cudaError_t err = set_smem(kx, xc.smem);
    if (err != cudaSuccess) return (int)err;
    kx<<<(unsigned)xc.row_tiles, kThreads, xc.smem, (cudaStream_t)stream>>>(
        static_cast<const bf16_bits*>(dg),
        static_cast<const bf16_bits*>(w_aug), static_cast<bf16_bits*>(dx), M,
        C, H, xc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const DwCfg wc = dw_cfg(M, C, H);
    const bool vec = vec_g && C % 8 == 0 && H % 8 == 0 && aligned16(x) &&
                     aligned16(hs);
    auto kw =
        vec ? lstm_bwd_dw_kernel<true> : lstm_bwd_dw_kernel<false>;
    err = set_smem(kw, wc.smem);
    if (err != cudaSuccess) return (int)err;
    kw<<<(unsigned)(wc.chunks * wc.n_col), kThreads, wc.smem,
         (cudaStream_t)stream>>>(
        static_cast<const bf16_bits*>(x), static_cast<const bf16_bits*>(hs),
        static_cast<const bf16_bits*>(dg), static_cast<float*>(partials), M,
        B, C, H, wc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    chunks = wc.chunks;
  }
  // dW = the chunks' partials summed in chunk order
  launch_ordered_sum<0>(static_cast<const float*>(partials),
                        static_cast<float*>(dw), chunks, n_elems,
                        (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// dW's K chunks for T * B rows (at least 1, so the scratch is never empty)
int lstm_bwd_mma_chunks(int T, int B, int C, int H) {
  const long long M = (long long)T * B;
  if (M <= 0) return 1;
  return dw_cfg(M, C, H).chunks;
}

int lstm_bwd_mma_fits(int C, int H) { return fits(C, H) ? 1 : 0; }
int lstm_bwd_mma_max_h(void) { return kMaxH; }
int lstm_bwd_mma_max_k(void) { return kMaxK; }

const char* lstm_bwd_mma_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
