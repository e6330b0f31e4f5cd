// Conv + BatchNorm(train) + swish backward, stride 1 (K6), on Hopper (sm_90a).
//
// Replaces the TPU kernel of remora_tpu/kernels/pallas_convbn.py:
// conv_bn_swish_bwd (its pl.pallas_call runs _bwd_kernel), the whole backward
// of out = swish(gamma * (y - mu) * r + beta), y = conv1d(x, w) (VALID, no
// bias; the bias cancels in the normalisation):
//
//   xhat = (y - mu) * r;  z = gamma * xhat + beta;  s = sigmoid(z)
//   dz = dout * (s + z * s * (1 - s))
//   dgamma = sum dz * xhat;  dbeta = sum dz          (over every (b, t < To))
//   dy = gamma * r * (dz - dbeta / n - xhat * dgamma / n),  n = B * To
//   db = sum dy;  dw[o, i, k] = sum x[b, t + k, i] dy[b, t, o]
//   dx[b, s, i] = sum_{k, o} dy[b, s - k, o] w[o, i, k]
//
// Rounding points (the Pallas kernel's): operands in the compute dtype T (w
// cast to T by the caller), every product and sum in f32; dz from the f32
// cotangent; dy in f32, db summed from it, then rounded to T once before the
// dw and dx products; dx's f32 sum over taps and channels rounded once.
//
// Design. The TPU kernel is one sequential grid of two phases that recomputes
// the conv in both. Blocks of a CUDA grid run in no order, so the batch-wide
// dgamma/dbeta barrier becomes a launch boundary, and y is computed once and
// kept in f32 (see the bound below for why):
//   1. the y conv: y = conv(x, w) for a (batch element, row tile), written
//      in f32; dz in the epilogue, each block's dgamma/dbeta partial summed
//      in a fixed order;
//   2. ordered_sum (or ordered_sum_runs): dgamma, dbeta = the partials
//      summed in block order;
//   3. dy: from y and dout (elementwise), rounded to T; each batch element's
//      db partial;
//   4. ordered_sum: db;
//   5. the dx conv: dx = conv(dy zero-padded by K - 1 rows, w transposed and
//      flipped), rounded once to T; skipped when the caller needs no dx;
//   6. dw as a split-K product over (b, t) chunks, each block a partial;
//   7. ordered_sum: dw.
// No atomics anywhere: every cross-block sum runs in block order, so a call
// repeats bit for bit.
//
// Three products (y, dx, dw), three ways to run them, picked by shape
// (layout(), convbn_bwd_path):
//   - mma.sync bf16 (bf16, I and O >= 8): implicit GEMMs on the tensor
//     cores, mma.sync.m16n8k16 with f32 accumulators (the Pallas kernel's
//     bf16 MXU passes with f32 results). The operands are time-major in
//     device memory (time_major_kernel copies x to (B, Ti, I16), dy is
//     written as (B, To, O16); 16 = channels padded to 16), so every tile is
//     rows of 16 bytes that cp.async copies as they are, three stages in
//     flight, at most 64 output channels a block. Staged [row][channel],
//     tap k's A operand is the same tile k rows down: ldmatrix takes one
//     row address a lane, so the shift is an offset and the tile is staged
//     once for all K taps. dw reads dy^T and
//     the shifted x rows with ldmatrix.trans. Weights are packed in the
//     wrapper as (K, N16, C16) bf16, mma's col-major B.
//   - fp32 register tiles (f32, I and O >= 8, K = 5): TF32 stays off, so
//     the products stay on the FP32 pipes, as register-tiled implicit GEMMs
//     fed from shared memory by cp.async, two stages. The conv's thread owns
//     8 rows x 8 channels and reads, per input channel, a 12-row window (3
//     float4) and per tap 8 weights (2 float4): 64 FMAs a tap on 5 + 3/5
//     loads. dw's thread owns 8 output channels x 5 taps of one input
//     channel: 160 FMAs on 10 loads.
//   - fp32 rows (every other shape: the signal convs 1 -> 4 and 4 -> 16,
//     which fill neither an m16n8k16 tile nor an 8-channel register tile,
//     and f32 at K != 5): conv_rows_kernel and dw_kernel, FP32 FMAs on
//     either dtype.
//
// Bounds at the main path's widest stride-1 block (merge_conv1: B = 2048,
// Ti = 128, I = 128, O = 64, K = 5): three products of 2*B*To*I*O*K = 20.8
// GFLOP (y once, dx, dw) = 62.4 GFLOP; x + dout + dx = 333 MB (f32) or 167
// MB (bf16). f32: 0.93 ms at 67 TFLOP/s FP32 against 0.10 ms of bytes, so
// the FP32 pipes bound it and the register tiles are for the FMA rate. bf16:
// 0.063 ms at 989 TFLOP/s, 0.05 ms of bytes, so on the tensor cores the
// kernel is bound by what it moves: this plan moves 625 MB (x read once,
// its time-major copy written once and read twice, dout read twice, y's
// f32 write and read, dy's write and two reads, dx's write), 0.19 ms at
// 3.35 TB/s, and the tiles' latency keeps it above that. Recomputing y in
// step 3 instead of storing it (the TPU kernel's choice: 20.8 GFLOP, ~0.03
// ms on the tensor cores, against y's 130 MB round trip) and fusing dy into
// the dx and dw prologues are the next cuts; this design keeps one plan for
// all three product paths.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCT = 4;         // output channels per thread (one float4)
constexpr int kMaxK = 32;      // taps
constexpr int kMaxC = 1024;    // input or output channels
constexpr size_t kSmemMax = 232448;  // 227 KB a block can use
constexpr int kDwTarget = 4 * 132;   // dw blocks wanted: four waves of SMs

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

__device__ __forceinline__ float sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// dz of one output element (_bwd_kernel's order of operations)
__device__ __forceinline__ float bn_swish_dz(float y, float g, float mu,
                                             float gamma, float beta,
                                             float r, float* xhat) {
  const float xh = (y - mu) * r;
  const float z = gamma * xh + beta;
  const float s = sigmoid(z);
  *xhat = xh;
  return g * (s + z * s * (1.0f - s));
}

// ------------------------- the row-tiled conv -------------------------

struct ConvCfg {
  int groups;   // ceil(c_out / 4) channel groups
  int gpp;      // group slots per pass (a power of two <= kWarps)
  int rth;      // row threads per group slot = kThreads / gpp (>= 32)
  int rt;       // rows per thread
  int tt;       // output rows per tile = rth * rt
  int rows_in;  // staged input rows = tt + K - 1
  int ld;       // shared row stride of one channel: rows_in, made odd
  int tiles;    // row tiles per batch element
  size_t smem;  // input tile, plus the stats reduction when asked
};

ConvCfg conv_cfg(int c_in, int c_out, int K, int out_len, int rt,
                 bool stats) {
  ConvCfg c;
  c.groups = (c_out + kCT - 1) / kCT;
  c.gpp = 1;
  while (c.gpp < kWarps && c.gpp * 2 <= c.groups) c.gpp *= 2;
  c.rth = kThreads / c.gpp;
  c.rt = rt;
  c.tt = c.rth * rt;
  c.rows_in = c.tt + K - 1;
  c.ld = c.rows_in | 1;
  c.tiles = (out_len + c.tt - 1) / c.tt;
  c.smem = (size_t)c_in * c.ld * sizeof(float);
  if (stats) c.smem += (size_t)2 * (c.rth / 32) * c_out * sizeof(float);
  return c;
}

// two rows a thread, or one where two do not fit in shared memory
ConvCfg pick_conv_cfg(int c_in, int c_out, int K, int out_len, bool stats) {
  ConvCfg c = conv_cfg(c_in, c_out, K, out_len, 2, stats);
  if (c.smem > kSmemMax) c = conv_cfg(c_in, c_out, K, out_len, 1, stats);
  return c;
}

// out[b, o, t] = sum_{k, c} in[b, c, t + k - pad] * W[o, c, k] for t <
// out_len, input rows outside [0, in_len) read as 0. wp holds W as float4
// groups of 4 output channels: wp[(g * K + k) * c_in + c] = W[4g .. 4g+3, c,
// k]. kStats: the conv goes to y (f32) and the epilogue forms dz from dout
// and writes the block's dgamma/dbeta partial to stats_part[block][2][c_out];
// otherwise it goes to out, rounded to T.
template <typename T, int RT, bool kStats>
__global__ void __launch_bounds__(kThreads)
    conv_rows_kernel(const T* __restrict__ in, long long sb, long long sc,
                     long long st, int in_len, int pad, int c_in,
                     const float4* __restrict__ wp, int K, int c_out,
                     int out_len, ConvCfg cfg, const T* __restrict__ dout,
                     long long gb, long long gc, long long gt,
                     const float* __restrict__ sv, float* __restrict__ y,
                     float* __restrict__ stats_part, T* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* s_in = smem;  // [c_in][ld]
  const int tid = threadIdx.x;
  const int b = blockIdx.x / cfg.tiles;
  const int t0 = (blockIdx.x % cfg.tiles) * cfg.tt;
  const int rows_in = cfg.rows_in, ld = cfg.ld;
  const T* inb = in + (long long)b * sb;

  const int n_stage = c_in * rows_in;
  if (st == 1) {  // rows contiguous: lanes walk rows
    for (int e = tid; e < n_stage; e += kThreads) {
      const int c = e / rows_in, u = e - c * rows_in;
      const int g = t0 + u - pad;
      s_in[c * ld + u] =
          (g >= 0 && g < in_len) ? to_f32(inb[c * sc + g]) : 0.f;
    }
  } else {  // lanes walk channels (the odd stride keeps the banks apart)
    for (int e = tid; e < n_stage; e += kThreads) {
      const int u = e / c_in, c = e - u * c_in;
      const int g = t0 + u - pad;
      s_in[c * ld + u] =
          (g >= 0 && g < in_len) ? to_f32(inb[c * sc + g * st]) : 0.f;
    }
  }
  __syncthreads();

  const int rti = tid % cfg.rth;  // row thread
  const int gs = tid / cfg.rth;   // group slot: one per warp
  const int n_rw = cfg.rth / 32;  // warps per group slot
  float* red = smem + (size_t)c_in * ld;  // [2][n_rw][c_out] (kStats)

  for (int g = gs; g < cfg.groups; g += cfg.gpp) {
    float acc[RT][kCT];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int j = 0; j < kCT; ++j) acc[r][j] = 0.f;
    const float4* wg = wp + (size_t)g * K * c_in;
    for (int k = 0; k < K; ++k) {
      const float4* wk = wg + (size_t)k * c_in;
      const float* xk = s_in + rti + k;
#pragma unroll 8
      for (int c = 0; c < c_in; ++c) {
        const float4 w = __ldg(wk + c);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float v = xk[c * ld + r * cfg.rth];
          acc[r][0] = fmaf(v, w.x, acc[r][0]);
          acc[r][1] = fmaf(v, w.y, acc[r][1]);
          acc[r][2] = fmaf(v, w.z, acc[r][2]);
          acc[r][3] = fmaf(v, w.w, acc[r][3]);
        }
      }
    }

    if (kStats) {
      float pg[kCT], pb[kCT];
#pragma unroll
      for (int j = 0; j < kCT; ++j) pg[j] = pb[j] = 0.f;
#pragma unroll
      for (int j = 0; j < kCT; ++j) {
        const int o = g * kCT + j;
        if (o >= c_out) continue;
        const float gamma = __ldg(sv + o), beta = __ldg(sv + c_out + o);
        const float mu = __ldg(sv + 2 * c_out + o);
        const float r_ = __ldg(sv + 3 * c_out + o);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int t = t0 + rti + r * cfg.rth;
          if (t >= out_len) continue;
          const float yv = acc[r][j];
          y[((long long)b * c_out + o) * out_len + t] = yv;
          float xh;
          const float dz = bn_swish_dz(
              yv, to_f32(dout[b * gb + o * gc + t * gt]), mu, gamma, beta,
              r_, &xh);
          pg[j] += dz * xh;
          pb[j] += dz;
        }
      }
#pragma unroll
      for (int j = 0; j < kCT; ++j) {
        const float sg = warp_sum(pg[j]);
        const float sbt = warp_sum(pb[j]);
        const int o = g * kCT + j;
        if ((tid & 31) == 0 && o < c_out) {
          red[(rti / 32) * c_out + o] = sg;
          red[(n_rw + rti / 32) * c_out + o] = sbt;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kCT; ++j) {
        const int o = g * kCT + j;
        if (o >= c_out) continue;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int t = t0 + rti + r * cfg.rth;
          if (t < out_len) {
            out[((long long)b * c_out + o) * out_len + t] =
                from_f32<T>(acc[r][j]);
          }
        }
      }
    }
  }

  if (kStats) {
    __syncthreads();
    float* part = stats_part + (size_t)blockIdx.x * 2 * c_out;
    for (int o = tid; o < c_out; o += kThreads) {
      float sg = 0.f, sbt = 0.f;
      for (int w = 0; w < n_rw; ++w) {
        sg += red[w * c_out + o];
        sbt += red[(n_rw + w) * c_out + o];
      }
      part[o] = sg;
      part[c_out + o] = sbt;
    }
  }
}

// the partial sums run in part order, runs of kRun parts summed apart and
// then the runs (mma_sm90.cuh's ordered_sum<kRun>)
constexpr int kRun = 64;

// ordered_sum<kRun> for many parts: one block an element, each thread a
// run, the runs then summed in order by one thread (the same sums)
__global__ void ordered_sum_runs(const float* __restrict__ partials,
                                 float* __restrict__ out, int n_parts,
                                 int n_elems) {
  extern __shared__ float runs[];
  const int e = blockIdx.x;
  const int n_runs = (n_parts + kRun - 1) / kRun;
  for (int r = threadIdx.x; r < n_runs; r += blockDim.x) {
    const int p1 = min(n_parts, (r + 1) * kRun);
    float run = 0.f;
    for (int p = r * kRun; p < p1; ++p) {
      run += partials[(size_t)p * n_elems + e];
    }
    runs[r] = run;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < n_runs; ++r) s += runs[r];
    out[e] = s;
  }
}

// dy of one batch element (block b), rounded into T as (B, O, To), and its
// db partial (the f32 sum of the unrounded dy): db_part[b][o]. A warp takes
// one channel at a time and its lanes the rows, four independent loads in
// flight a lane, so the pass is not bound by one load's latency per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dy_kernel(const float* __restrict__ y, const T* __restrict__ dout,
              long long gb, long long gc, long long gt,
              const float* __restrict__ sv, const float* __restrict__ dgb,
              float n_total, int O, int To, T* __restrict__ dyk,
              float* __restrict__ db_part) {
  constexpr int kU = 4;  // rows a lane per step
  const int lane = threadIdx.x & 31, b = blockIdx.x;
  for (int o = threadIdx.x / 32; o < O; o += kWarps) {
    const float gamma = __ldg(sv + o), beta = __ldg(sv + O + o);
    const float mu = __ldg(sv + 2 * O + o), r = __ldg(sv + 3 * O + o);
    const float gr = gamma * r;
    const float mean_dbeta = __ldg(dgb + O + o) / n_total;
    const float mean_dgamma = __ldg(dgb + o) / n_total;
    const long long row = ((long long)b * O + o) * To;
    const T* g_row = dout + b * gb + o * gc;
    float part = 0.f;
    for (int t0 = 0; t0 < To; t0 += 32 * kU) {
      float yv[kU], gv[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int t = t0 + lane + 32 * u;
        yv[u] = t < To ? y[row + t] : 0.f;
        gv[u] = t < To ? to_f32(g_row[t * gt]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int t = t0 + lane + 32 * u;
        if (t >= To) continue;
        float xh;
        const float dz = bn_swish_dz(yv[u], gv[u], mu, gamma, beta, r, &xh);
        const float dy = gr * (dz - mean_dbeta - xh * mean_dgamma);
        dyk[row + t] = from_f32<T>(dy);
        part += dy;
      }
    }
    part = warp_sum(part);
    if (lane == 0) db_part[(size_t)b * O + o] = part;
  }
}

// ------------------------- dw: split-K product -------------------------

struct DwCfg {
  int og, jg, rs;  // thread grid: og x jg cells of 4 x 4, rs row splits
  int tn;          // rows staged per step
  int to, tj;      // output tile: to channels x tj (i, k) columns
  int o_tiles, j_tiles, chunks, per_chunk;
  size_t smem;
};

DwCfg dw_cfg(int B, int O, int J) {
  DwCfg c;
  c.og = (O + 3) / 4;
  if (c.og > 16) c.og = 16;
  c.jg = (J + 3) / 4;
  if (c.jg > kThreads / c.og) c.jg = kThreads / c.og;
  c.rs = kThreads / (c.og * c.jg);
  c.tn = c.rs > 32 ? c.rs : 32;
  c.to = 4 * c.og;
  c.tj = 4 * c.jg;
  c.o_tiles = (O + c.to - 1) / c.to;
  c.j_tiles = (J + c.tj - 1) / c.tj;
  int chunks = (kDwTarget + c.o_tiles * c.j_tiles - 1) /
               (c.o_tiles * c.j_tiles);
  if (chunks > B) chunks = B;
  if (chunks < 1) chunks = 1;
  c.per_chunk = (B + chunks - 1) / chunks;
  c.chunks = (B + c.per_chunk - 1) / c.per_chunk;
  // Bs [tn][tj] (16-byte rows), As [to][tn + 1], red [rs][og * jg * 16]
  c.smem = ((size_t)c.tn * c.tj + (size_t)c.to * (c.tn + 1) +
            (c.rs > 1 ? (size_t)kThreads * 16 : 0)) *
           sizeof(float);
  return c;
}

// dw_part[chunk][o][i * K + k] = sum over the chunk's (b, t < To) of
// x[b, i, t + k] * dyk[b, o, t]
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dw_kernel(const T* __restrict__ x, long long sb, long long sc,
              long long st, const T* __restrict__ dyk, int B, int To, int O,
              int I, int K, DwCfg cfg, float* __restrict__ dw_part) {
  extern __shared__ __align__(16) float smem[];
  const int J = I * K;
  const int tn = cfg.tn, tj = cfg.tj, to = cfg.to;
  float* Bs = smem;                         // [tn][tj]
  float* As = smem + (size_t)tn * tj;       // [to][tn + 1]
  float* red = As + (size_t)to * (tn + 1);  // [rs][og * jg * 16]
  const int tid = threadIdx.x;
  const int o0 = blockIdx.y * to, j0 = blockIdx.x * tj;
  const int ogi = tid % cfg.og;
  const int jgi = (tid / cfg.og) % cfg.jg;
  const int rsi = tid / (cfg.og * cfg.jg);
  // the og x jg x rs threads that own cells; the rest only stage tiles
  const bool owner = rsi < cfg.rs;
  const int b_lo = blockIdx.z * cfg.per_chunk;
  const int b_hi = min(B, b_lo + cfg.per_chunk);

  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[q][p] = 0.f;

  for (int b = b_lo; b < b_hi; ++b) {
    const T* xb = x + (long long)b * sb;
    const T* db = dyk + (long long)b * O * To;
    for (int t0 = 0; t0 < To; t0 += tn) {
      __syncthreads();  // the previous step's tiles are consumed
      for (int e = tid; e < to * tn; e += kThreads) {
        const int oo = e / tn, n = e - oo * tn;
        const int o = o0 + oo, t = t0 + n;
        As[oo * (tn + 1) + n] =
            (o < O && t < To) ? to_f32(db[(long long)o * To + t]) : 0.f;
      }
      for (int e = tid; e < tn * tj; e += kThreads) {
        const int n = e / tj, jj = e - n * tj;
        const int j = j0 + jj, t = t0 + n;
        float v = 0.f;
        if (j < J && t < To) {
          const int i = j / K, k = j - i * K;
          v = to_f32(xb[i * sc + (long long)(t + k) * st]);
        }
        Bs[n * tj + jj] = v;
      }
      __syncthreads();
      if (owner) {
        // the tile's rows summed apart, then added to the running sum:
        // chains of tn / rs and of the tile count, not of every row
        float tile[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int p = 0; p < 4; ++p) tile[q][p] = 0.f;
        for (int n = rsi; n < tn; n += cfg.rs) {
          float a[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) a[q] = As[(ogi * 4 + q) * (tn + 1) + n];
          const float4 bv =
              *reinterpret_cast<const float4*>(Bs + n * tj + jgi * 4);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            tile[q][0] = fmaf(a[q], bv.x, tile[q][0]);
            tile[q][1] = fmaf(a[q], bv.y, tile[q][1]);
            tile[q][2] = fmaf(a[q], bv.z, tile[q][2]);
            tile[q][3] = fmaf(a[q], bv.w, tile[q][3]);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int p = 0; p < 4; ++p) acc[q][p] += tile[q][p];
      }
    }
  }

  float* part = dw_part + (size_t)blockIdx.z * O * J;
  const int cells = cfg.og * cfg.jg;
  if (cfg.rs == 1) {
    if (!owner) return;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int o = o0 + ogi * 4 + q, j = j0 + jgi * 4 + p;
        if (o < O && j < J) part[(size_t)o * J + j] = acc[q][p];
      }
    return;
  }
  const int cell = jgi * cfg.og + ogi;
  if (owner) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int p = 0; p < 4; ++p)
        red[((size_t)rsi * cells + cell) * 16 + q * 4 + p] = acc[q][p];
  }
  __syncthreads();
  for (int e = tid; e < cells * 16; e += kThreads) {
    float s = 0.f;
    for (int r = 0; r < cfg.rs; ++r) s += red[(size_t)r * cells * 16 + e];
    const int c = e / 16, q = (e % 16) / 4, p = e % 4;
    const int o = o0 + (c % cfg.og) * 4 + q;
    const int j = j0 + (c / cfg.og) * 4 + p;
    if (o < O && j < J) part[(size_t)o * J + j] = s;
  }
}

// ------------------- the products of the wider blocks -------------------

// The three products of a block with I, O >= 8 run as implicit GEMMs over
// tiles staged in shared memory: bf16 on the tensor cores (mma.sync), f32 as
// register tiles on the FP32 pipes. Both convs (y, and dx from dy) are one
// kernel: out[b, n, t] = sum_{k, c} in[b, c, t + k - pad] * W[k][c][n].
// y and out are (B, c_out, out_len) on the register tiles and time-major
// (B, out_len, c_out) on the tensor cores.
struct ConvIO {
  const void* in;  // (B, c_in, in_len) by its element strides
  long long sb, sc, st;
  int in_len, pad, c_in;
  const void* w;  // packed weights (pack_weights_mma / pack_weights_tiles)
  int K, c_out, out_len;
  const void* dout;  // kStats: (B, c_out, out_len) by its element strides
  long long gb, gc, gt;
  const float* sv;    // kStats: gamma, beta, mu, r
  float* y;           // kStats: y in f32
  float* stats_part;  // kStats: [B * tiles][2][c_out]
  void* out;          // otherwise: the conv in the compute dtype
};

// --- bf16: mma.sync.m16n8k16 with f32 accumulators (mma_sm90.cuh) ---

// The tensor-core path keeps its operands time-major in device memory, so
// that every tile is a run of 16-byte rows that cp.async copies as it is:
// x as (B, Ti, I16), dy as (B, To, O16), y as (B, To, O) f32, dx written
// as (B, Ti, I); I16 and O16 are the channel counts rounded up to 16, the
// padding zero.

// out[b, t, c] = in[b, c, t] for c < C, 0 for C <= c < cpad: 64 x 64 tiles
// through shared memory, read as 16-byte runs of 8 rows where the rows are
// contiguous and aligned, written as 16-byte runs of 8 channels
__global__ void __launch_bounds__(kThreads)
    time_major_kernel(const bf16_bits* __restrict__ in, long long sb,
                      long long sc, long long st, int C, int T, int cpad,
                      bf16_bits* __restrict__ out) {
  constexpr int kLd = 72;  // [c][t] row stride: 16-byte aligned rows
  __shared__ __align__(16) bf16_bits tile[64 * kLd];
  const int b = blockIdx.z, t0 = blockIdx.x * 64, c0 = blockIdx.y * 64;
  const bf16_bits* inb = in + (long long)b * sb;
  const bool vec = st == 1 && sc % 8 == 0 && sb % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(in) % 16 == 0;
  for (int e = threadIdx.x; e < 64 * 8; e += kThreads) {
    const int cl = e >> 3, m = e & 7;
    const int c = c0 + cl, t = t0 + 8 * m;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (c < C) {
      if (vec && t + 8 <= T) {
        v = *reinterpret_cast<const uint4*>(inb + c * sc + t);
      } else {
        __align__(16) bf16_bits h[8];
        for (int i = 0; i < 8; ++i) {
          h[i] = t + i < T ? inb[c * sc + (t + i) * st] : (bf16_bits)0;
        }
        v = *reinterpret_cast<const uint4*>(h);
      }
    }
    *reinterpret_cast<uint4*>(tile + cl * kLd + 8 * m) = v;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 64 * 8; e += kThreads) {
    const int m = e >> 6, tl = e & 63;  // lanes walk rows: no bank conflicts
    const int t = t0 + tl, c = c0 + 8 * m;
    if (t >= T || c >= cpad) continue;
    __align__(16) bf16_bits h[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = tile[(8 * m + i) * kLd + tl];
    *reinterpret_cast<uint4*>(out + ((long long)b * T + t) * cpad + c) =
        *reinterpret_cast<const uint4*>(h);
  }
}

constexpr int kMmaTM = 128;  // output rows a block: 8 warps x 16
constexpr int kMmaCC = 16;   // input channels a depth step (one k16)
constexpr int kMmaLd = 24;   // bf16 row stride of a staged [row][16] tile:
                             // 48 bytes, so ldmatrix's 8 rows hit 8 bank
                             // quads
constexpr int kMmaNMax = 64;  // output channels a block at most (8 n8)
constexpr int kStages = 3;    // cp.async stages in flight on this path

struct MmaCfg {
  int nb;       // output channels a block (a multiple of 16)
  int n_tiles;  // blocks across the output channels
  int npad;     // packed output channels = nb * n_tiles
  int cpad;     // input channels rounded up to 16: the operand's row length
  int tiles;    // row tiles a batch element
  int rows_in;  // staged input rows = kMmaTM + K - 1
  int stage;    // bf16 elements of one stage: input rows, then weights
  size_t red;   // byte offset of the stats reduction
  size_t smem;
};

int round_up(int v, int m) { return (v + m - 1) / m * m; }

MmaCfg mma_cfg(int c_in, int c_out, int K, int out_len, bool stats) {
  MmaCfg c;
  const int n16 = round_up(c_out, 16);
  c.n_tiles = (n16 + kMmaNMax - 1) / kMmaNMax;
  c.nb = round_up((n16 + c.n_tiles - 1) / c.n_tiles, 16);
  c.npad = c.nb * c.n_tiles;
  c.cpad = round_up(c_in, kMmaCC);
  c.tiles = (out_len + kMmaTM - 1) / kMmaTM;
  c.rows_in = kMmaTM + K - 1;
  c.stage = (c.rows_in + K * c.nb) * kMmaLd;
  // the stages, which the epilogue reuses for the output tile, then the
  // stats reduction ([2][256 / nb][nb] floats)
  size_t stages = (size_t)kStages * c.stage * 2;
  const size_t tile =
      (size_t)kMmaTM * (stats ? (c.nb + 4) * 4 : (c.nb + 8) * 2);
  if (stages < tile) stages = tile;
  c.red = stages;
  c.smem = stages + (stats ? (size_t)2 * kThreads * sizeof(float) : 0);
  return c;
}

// The implicit-GEMM conv on the tensor cores. in is time-major (B, in_len,
// cpad). Block: (b, row tile, channel tile); warp w owns rows 16w .. 16w + 15
// of the tile and all nb channels. Each depth step stages 16 input channels
// of the tile's rows ([row][channel]: tap k's A operand is the same tile k
// rows down) and the K x nb x 16 weights ([k][n][channel]: B's col layout),
// the next two steps' copies in flight while this one's K ldmatrix + mma
// passes run. The packed weights are wq[k][n][c] (npad x cpad). kStats: y
// goes out time-major (B, out_len, c_out) f32 with dz and the dgamma/dbeta
// partials; otherwise out, time-major (B, out_len, c_out) bf16. kNT: n8
// tiles a warp at most (nb / 8 <= kNT), so narrow blocks hold fewer
// accumulators and more blocks fit on an SM.
template <bool kStats, int kNT>
__global__ void __launch_bounds__(kThreads, 2)
    conv_mma_kernel(ConvIO p, MmaCfg cfg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_bits* stages = reinterpret_cast<bf16_bits*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw + cfg.red);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int blk = blockIdx.x;
  const int nt_i = blk % cfg.n_tiles;
  blk /= cfg.n_tiles;
  const int b = blk / cfg.tiles;
  const int t0 = (blk % cfg.tiles) * kMmaTM, n0 = nt_i * cfg.nb;
  const int K = p.K, nb = cfg.nb, nt = nb / 8, rows_in = cfg.rows_in;
  const bf16_bits* inb =
      static_cast<const bf16_bits*>(p.in) + (long long)b * p.sb;
  const bf16_bits* wq = static_cast<const bf16_bits*>(p.w);

  auto issue = [&](int c0, int s) {
    bf16_bits* s_in = stages + (size_t)s * cfg.stage;
    bf16_bits* s_w = s_in + (size_t)rows_in * kMmaLd;
    for (int e = tid; e < rows_in * 2; e += kThreads) {
      const int u = e >> 1, h = e & 1;
      const int g = t0 + u - p.pad;
      const bool valid = g >= 0 && g < p.in_len;
      cp_async16z(s_in + u * kMmaLd + 8 * h,
                  valid ? inb + (long long)g * p.st + c0 + 8 * h : inb, valid);
    }
    for (int e = tid; e < K * nb * 2; e += kThreads) {
      const int h = e & 1, kn = e >> 1;
      const int k = kn / nb, n = kn - k * nb;
      cp_async16(s_w + (size_t)kn * kMmaLd + 8 * h,
                 wq + ((size_t)k * cfg.npad + n0 + n) * cfg.cpad + c0 + 8 * h);
    }
  };

  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;

  const int n_steps = cfg.cpad / kMmaCC;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) issue(s * kMmaCC, s);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    const int ahead = step + kStages - 1;
    if (ahead < n_steps) issue(ahead * kMmaCC, ahead % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // step's group has landed
    __syncthreads();
    const bf16_bits* s_in = stages + (size_t)(step % kStages) * cfg.stage;
    const bf16_bits* s_w = s_in + (size_t)rows_in * kMmaLd;
    for (int k = 0; k < K; ++k) {
      uint32_t a[4];
      ldsm_x4(a, smem_u32(s_in + (warp * 16 + k + (lane & 15)) * kMmaLd +
                          (lane >> 4) * 8));
      const bf16_bits* wk = s_w + (size_t)k * nb * kMmaLd;
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        if (j < nt) {
          uint32_t bb[4];
          ldsm_x4(bb, smem_u32(wk + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) *
                                        kMmaLd +
                                    ((lane >> 3) & 1) * 8));
          mma_16816(acc[j], a, bb);
          mma_16816(acc[j + 1], a, bb + 2);
        }
      }
    }
    __syncthreads();  // stage step % kStages is free for step + kStages
  }

  // The block's outputs go through shared memory (the stages are free), so
  // that y and dx leave as whole rows. Accumulator (j, v): row 16 warp +
  // lane / 4 + 8 (v / 2), channel 8 j + 2 (lane % 4) + v % 2.
  const int g = lane >> 2, q = lane & 3;
  if (kStats) {
    const int ldt = nb + 4;
    float* tile = reinterpret_cast<float*>(smem_raw);  // [kMmaTM][ldt]
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j >= nt) continue;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        *reinterpret_cast<float2*>(
            tile + (warp * 16 + g + 8 * s) * ldt + 8 * j + 2 * q) =
            make_float2(acc[j][2 * s], acc[j][2 * s + 1]);
      }
    }
    __syncthreads();
    // thread: channel n0 + c, rows r0, r0 + R, ... (R = 256 / nb rows at a
    // time), dout of kU rows loaded before any is used; the column sums then
    // run over r0 in order
    constexpr int kU = 8;
    const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout);
    const int R = kThreads / nb, c = tid % nb, r0 = tid / nb, o = n0 + c;
    const int rows = min(kMmaTM, p.out_len - t0);
    float sg = 0.f, sbt = 0.f;
    if (r0 < R && o < p.c_out) {
      const float gamma = __ldg(p.sv + o), beta = __ldg(p.sv + p.c_out + o);
      const float mu = __ldg(p.sv + 2 * p.c_out + o);
      const float r = __ldg(p.sv + 3 * p.c_out + o);
      const __nv_bfloat16* g_col = dout + b * p.gb + o * p.gc;
      for (int row = r0; row < rows; row += kU * R) {
        float gv[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int rr = row + u * R;
          gv[u] = rr < rows ? to_f32(g_col[(t0 + rr) * p.gt]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int rr = row + u * R;
          if (rr >= rows) break;
          const float yv = tile[rr * ldt + c];
          p.y[((long long)b * p.out_len + t0 + rr) * p.c_out + o] = yv;
          float xh;
          const float dz = bn_swish_dz(yv, gv[u], mu, gamma, beta, r, &xh);
          sg += dz * xh;
          sbt += dz;
        }
      }
    }
    if (r0 < R) {
      red[r0 * nb + c] = sg;
      red[(R + r0) * nb + c] = sbt;
    }
    __syncthreads();
    float* part = p.stats_part + (size_t)blk * 2 * p.c_out;
    if (r0 == 0 && o < p.c_out) {
      float s_g = 0.f, s_b = 0.f;
      for (int w = 0; w < R; ++w) {
        s_g += red[w * nb + c];
        s_b += red[(R + w) * nb + c];
      }
      part[o] = s_g;
      part[p.c_out + o] = s_b;
    }
  } else {
    const int ldt = nb + 8;  // bf16: rows of 16-byte runs, 16-byte aligned
    bf16_bits* tile = reinterpret_cast<bf16_bits*>(smem_raw);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j >= nt) continue;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(acc[j][2 * s], acc[j][2 * s + 1]);
        *reinterpret_cast<__nv_bfloat162*>(
            tile + (warp * 16 + g + 8 * s) * ldt + 8 * j + 2 * q) = v;
      }
    }
    __syncthreads();
    bf16_bits* out = static_cast<bf16_bits*>(p.out);
    const int rows = min(kMmaTM, p.out_len - t0);
    if (p.c_out % 8 == 0) {  // rows of whole 16-byte runs
      const int runs = nb / 8;
      for (int e = tid; e < rows * runs; e += kThreads) {
        const int row = e / runs, m = e - row * runs, o = n0 + 8 * m;
        if (o >= p.c_out) continue;
        *reinterpret_cast<uint4*>(
            out + ((long long)b * p.out_len + t0 + row) * p.c_out + o) =
            *reinterpret_cast<const uint4*>(tile + row * ldt + 8 * m);
      }
    } else {  // lanes walk a row's channels
      const int width = min(nb, p.c_out - n0);
      for (int e = tid; e < rows * width; e += kThreads) {
        const int row = e / width, c = e - row * width;
        out[((long long)b * p.out_len + t0 + row) * p.c_out + n0 + c] =
            tile[row * ldt + c];
      }
    }
  }
}

// time-major dy for the tensor-core path: y (B, To, O) f32 in, dyk (B, To,
// opad) out with zeros past O, and each batch element's db partial. A block
// is one batch element; its threads walk the channels (consecutive lanes,
// consecutive channels) and R = 256 / channels rows at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dy_tm_kernel(const float* __restrict__ y, const T* __restrict__ dout,
                 long long gb, long long gc, long long gt,
                 const float* __restrict__ sv, const float* __restrict__ dgb,
                 float n_total, int O, int opad, int To, T* __restrict__ dyk,
                 float* __restrict__ db_part) {
  __shared__ float red[kThreads];
  const int tid = threadIdx.x, b = blockIdx.x;
  for (int o0 = 0; o0 < opad; o0 += kThreads) {
    const int oc = min(kThreads, opad - o0);
    const int R = kThreads / oc;
    const int oi = tid % oc, rr = tid / oc, o = o0 + oi;
    float part = 0.f;
    if (rr < R) {
      const bool real = o < O;
      float gamma = 0.f, beta = 0.f, mu = 0.f, r = 0.f, mdb = 0.f, mdg = 0.f;
      if (real) {
        gamma = __ldg(sv + o);
        beta = __ldg(sv + O + o);
        mu = __ldg(sv + 2 * O + o);
        r = __ldg(sv + 3 * O + o);
        mdb = __ldg(dgb + O + o) / n_total;
        mdg = __ldg(dgb + o) / n_total;
      }
      const float gr = gamma * r;
#pragma unroll 4
      for (int t = rr; t < To; t += R) {
        float dy = 0.f;
        if (real) {
          float xh;
          const float dz = bn_swish_dz(
              y[((long long)b * To + t) * O + o],
              to_f32(dout[b * gb + o * gc + t * gt]), mu, gamma, beta, r, &xh);
          dy = gr * (dz - mdb - xh * mdg);
          part += dy;
        }
        dyk[((long long)b * To + t) * opad + o] = from_f32<T>(dy);
      }
      red[rr * oc + oi] = part;
    }
    __syncthreads();
    if (rr == 0 && o < O) {
      float s = 0.f;
      for (int w = 0; w < R; ++w) s += red[w * oc + oi];
      db_part[(size_t)b * O + o] = s;
    }
    __syncthreads();
  }
}

// dw on the tensor cores: dw_part[chunk][o][i * K + k] = sum over the
// chunk's (b, t < To) of dyk[b, t, o] * x[b, t + k, i], both time-major.
// Block: 16 mw output channels x 16 (8 / mw) input channels x up to 5 taps,
// mw = 1, 2 or 4 as O needs; warp w owns output channels 16 (w % mw) .. +
// 15 and input channels 16 (w / mw) .. + 15 of every tap. Each step stages
// 64 rows of dy and 68 of x ([row][channel], cp.async, the next two steps'
// copies in flight); A = dy^T and B = x rows shifted by the tap are both
// read with ldmatrix.trans. Row strides are 8 bf16 past a multiple of 16:
// ldmatrix's 8 rows then hit 8 bank quads.
constexpr int kDwMmaTT = 64;    // rows a step
constexpr int kDwMmaKC = 5;     // taps a block at most: all of K <= 5,
                                // else chunks of 4 (fewer accumulators)
constexpr int kDwMmaRowsB = kDwMmaTT + kDwMmaKC - 1;

struct DwMmaCfg {
  int mw;        // m16 tiles a block (warps along O)
  int o_blk;     // output channels a block = 16 mw
  int i_blk;     // input channels a block = 16 (8 / mw)
  int lda, ldb;  // bf16 row strides of the dy and x tiles
  int stage;     // bf16 elements of one stage
  int kc;        // taps a block: K <= 5 ? 5 : 4
  int i_tiles, k_chunks, o_tiles, chunks, per_chunk;
  size_t smem;
};

DwMmaCfg dw_mma_cfg(int B, int O, int I, int K) {
  DwMmaCfg c;
  c.mw = O <= 16 ? 1 : O <= 32 ? 2 : 4;
  c.o_blk = 16 * c.mw;
  c.i_blk = 16 * (kWarps / c.mw);
  c.lda = c.o_blk + 8;
  c.ldb = c.i_blk + 8;
  c.stage = kDwMmaTT * c.lda + kDwMmaRowsB * c.ldb;
  c.i_tiles = (I + c.i_blk - 1) / c.i_blk;
  c.kc = K <= kDwMmaKC ? kDwMmaKC : 4;
  c.k_chunks = (K + c.kc - 1) / c.kc;
  c.o_tiles = (O + c.o_blk - 1) / c.o_blk;
  const int tiles = c.i_tiles * c.k_chunks * c.o_tiles;
  int chunks = (kDwTarget + tiles - 1) / tiles;
  if (chunks > B) chunks = B;
  if (chunks < 1) chunks = 1;
  c.per_chunk = (B + chunks - 1) / chunks;
  c.chunks = (B + c.per_chunk - 1) / c.per_chunk;
  c.smem = (size_t)kStages * c.stage * 2;
  return c;
}

// x (B, Ti, ipad) and dyk (B, To, opad), time-major; kKC taps a block at
// most (the accumulators: 8 kKC a thread)
template <int kKC>
__global__ void __launch_bounds__(kThreads, 2)
    dw_mma_kernel(const bf16_bits* __restrict__ x, int ipad,
                  const bf16_bits* __restrict__ dyk, int opad, int B, int Ti,
                  int To, int O, int I, int K, DwMmaCfg cfg,
                  float* __restrict__ dw_part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_bits* stages = reinterpret_cast<bf16_bits*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i_tile = blockIdx.x % cfg.i_tiles;
  const int kb = (blockIdx.x / cfg.i_tiles) * kKC;
  const int nk = min(kKC, K - kb);
  const int i0 = i_tile * cfg.i_blk, o0 = blockIdx.y * cfg.o_blk;
  const int lda = cfg.lda, ldb = cfg.ldb;
  const int mw = warp % cfg.mw, ih = warp / cfg.mw;
  const int b_lo = blockIdx.z * cfg.per_chunk;
  const int b_hi = min(B, b_lo + cfg.per_chunk);
  const int t_steps = (To + kDwMmaTT - 1) / kDwMmaTT;
  const int n_steps = (b_hi - b_lo) * t_steps;

  // step (b, t0) into stage s: dy rows [t][o], then x rows [t][i]
  auto issue = [&](int step, int s) {
    const int b = b_lo + step / t_steps, t0 = (step % t_steps) * kDwMmaTT;
    bf16_bits* s_a = stages + (size_t)s * cfg.stage;
    bf16_bits* s_b = s_a + kDwMmaTT * lda;
    const bf16_bits* db = dyk + (long long)b * To * opad;
    const bf16_bits* xb = x + (long long)b * Ti * ipad;
    // 16-byte runs a row: 2 mw and 16 / mw, powers of two
    const int la = __ffs(cfg.o_blk / 8) - 1, lb = __ffs(cfg.i_blk / 8) - 1;
    for (int e = tid; e < kDwMmaTT << la; e += kThreads) {
      const int u = e >> la, m = e - (u << la);
      const int t = t0 + u, o = o0 + 8 * m;
      const bool valid = t < To && o < opad;
      cp_async16z(s_a + u * lda + 8 * m,
                  valid ? db + (long long)t * opad + o : db, valid);
    }
    for (int e = tid; e < kDwMmaRowsB << lb; e += kThreads) {
      const int u = e >> lb, m = e - (u << lb);
      const int t = t0 + kb + u, i = i0 + 8 * m;
      const bool valid = t < Ti && i < ipad;
      cp_async16z(s_b + u * ldb + 8 * m,
                  valid ? xb + (long long)t * ipad + i : xb, valid);
    }
  };

  float acc[kKC][2][4];
#pragma unroll
  for (int k = 0; k < kKC; ++k)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[k][n][v] = 0.f;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) issue(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    const int ahead = step + kStages - 1;
    if (ahead < n_steps) issue(ahead, ahead % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // step's group has landed
    __syncthreads();
    const bf16_bits* s_a = stages + (size_t)(step % kStages) * cfg.stage;
    const bf16_bits* s_b = s_a + kDwMmaTT * lda;
#pragma unroll
    for (int ts = 0; ts < kDwMmaTT / 16; ++ts) {
      uint32_t a[4];
      ldsm_x4_t(a, smem_u32(s_a +
                            (ts * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                lda +
                            mw * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
      for (int k = 0; k < kKC; ++k) {
        if (k < nk) {
          uint32_t bb[4];
          ldsm_x4_t(bb, smem_u32(s_b +
                                 (ts * 16 + k + (lane & 7) +
                                  ((lane >> 3) & 1) * 8) *
                                     ldb +
                                 ih * 16 + (lane >> 4) * 8));
          mma_16816(acc[k][0], a, bb);
          mma_16816(acc[k][1], a, bb + 2);
        }
      }
    }
    __syncthreads();  // stage step % kStages is free for step + kStages
  }

  float* part = dw_part + (size_t)blockIdx.z * O * I * K;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int k = 0; k < kKC; ++k) {
    if (k >= nk) continue;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int o = o0 + mw * 16 + g + 8 * (v >> 1);
        const int i = i0 + ih * 16 + 8 * n + 2 * q + (v & 1);
        if (o < O && i < I) {
          part[((size_t)o * I + i) * K + kb + k] = acc[k][n][v];
        }
      }
  }
}

// --- f32: register tiles on the FP32 pipes (TF32 stays off) ---

// The tiled f32 products unroll the taps: K = 5, every stride-1 block of
// the builtin models. Other K take the row kernels.
constexpr int kTK = 5;
constexpr int kTilesCC = 16;  // input channels a depth step
constexpr int kTilesRT = 8;   // output rows a thread

// The conv: thread (nj, tj) owns rows 8 tj .. 8 tj + 7 of the tile and the
// channels 4 nj .. 4 nj + 3 and 4 (nj + ng) .. + 3 (two float4 groups, so a
// warp's weight loads are consecutive). Per input channel it reads a window
// of 12 input rows (3 float4) and, per tap, 8 weights (2 float4): 64 FMAs a
// tap on 5 + 3 / 5 loads.
struct TilesCfg {
  int ng;       // channel groups of 8 = ceil(c_out / 8)
  int tg;       // row groups (8 rows each)
  int threads;  // ng * tg rounded up to a warp
  int tm;       // output rows a tile = 8 tg
  int ld;       // f32 row stride of one staged channel: tm + K - 1, to 4
  int tiles;    // row tiles a batch element
  int npad;     // packed output channels = 8 ng
  int cpad;     // packed input channels = c_in rounded up to 16
  size_t buf;   // floats of one stage: input tile, then weights
  size_t smem;  // two stages, or the output tile [npad][tm + 4] and the
                // stats reduction [2][c_out][tm / 4] where that is larger
};

TilesCfg tiles_cfg(int c_in, int c_out, int out_len, bool stats) {
  TilesCfg c;
  c.ng = (c_out + 7) / 8;
  c.tg = kThreads / c.ng;
  const int need = (out_len + kTilesRT - 1) / kTilesRT;
  if (c.tg > need) c.tg = need;
  if (c.tg < 1) c.tg = 1;
  c.threads = round_up(c.ng * c.tg, 32);
  c.tm = kTilesRT * c.tg;
  c.ld = round_up(c.tm + kTK - 1, 4);
  c.tiles = (out_len + c.tm - 1) / c.tm;
  c.npad = 8 * c.ng;
  c.cpad = round_up(c_in, kTilesCC);
  c.buf = (size_t)kTilesCC * c.ld + (size_t)kTK * kTilesCC * c.npad;
  size_t out = (size_t)c.npad * (c.tm + 4) +
               (stats ? (size_t)2 * c_out * (c.tm / 4) : 0);
  c.smem = (2 * c.buf > out ? 2 * c.buf : out) * sizeof(float);
  return c;
}

// The packed weights are wq[k][c][n] (cpad x npad).
template <bool kStats>
__global__ void __launch_bounds__(kThreads, 2)
    conv_tiles_kernel(ConvIO p, TilesCfg cfg) {
  extern __shared__ __align__(16) float smem[];
  // stage s: s_in [16][ld] at smem + s * buf, then s_w [K][16][npad]
  const int tid = threadIdx.x;
  const int b = blockIdx.x / cfg.tiles;
  const int t0 = (blockIdx.x % cfg.tiles) * cfg.tm;
  const int ng = cfg.ng, npad = cfg.npad, ld = cfg.ld;
  const int nj = tid % ng, tj = tid / ng;
  const bool owner = tj < cfg.tg;
  const int rows_in = cfg.tm + kTK - 1;
  const float* inb = static_cast<const float*>(p.in) + (long long)b * p.sb;
  const float* wq = static_cast<const float*>(p.w);

  // copies of depth step c0 into stage s, all in flight at once
  auto issue = [&](int c0, int s) {
    float* s_in = smem + s * cfg.buf;
    float* s_w = s_in + (size_t)kTilesCC * ld;
    const int n_stage = kTilesCC * rows_in;
    for (int e = tid; e < n_stage; e += cfg.threads) {
      int u, c;
      if (p.st == 1) {
        c = e / rows_in;
        u = e - c * rows_in;
      } else {
        u = e / kTilesCC;
        c = e - u * kTilesCC;
      }
      const int g = t0 + u - p.pad, cc = c0 + c;
      const bool valid = g >= 0 && g < p.in_len && cc < p.c_in;
      cp_async4(s_in + c * ld + u, valid ? inb + cc * p.sc + g * p.st : inb,
                valid);
    }
    const int per_k = kTilesCC * npad / 4;
    for (int e = tid; e < kTK * per_k; e += cfg.threads) {
      const int k = e / per_k, rem = e - k * per_k;
      cp_async16(s_w + 4 * e,
                 wq + ((size_t)k * cfg.cpad + c0) * npad + 4 * rem);
    }
    cp_async_commit();
  };

  float acc[kTilesRT][8];
#pragma unroll
  for (int r = 0; r < kTilesRT; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;

  const int n_steps = (p.c_in + kTilesCC - 1) / kTilesCC;
  issue(0, 0);
  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) {
      issue((step + 1) * kTilesCC, (step + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* s_in = smem + (step & 1) * cfg.buf;
    const float* s_w = s_in + (size_t)kTilesCC * ld;
    if (owner) {
#pragma unroll 2
      for (int c = 0; c < kTilesCC; ++c) {
        const float* xr = s_in + c * ld + kTilesRT * tj;
        float win[kTilesRT + kTK - 1];
#pragma unroll
        for (int v = 0; v < (kTilesRT + kTK - 1) / 4; ++v) {
          const float4 f = reinterpret_cast<const float4*>(xr)[v];
          win[4 * v] = f.x;
          win[4 * v + 1] = f.y;
          win[4 * v + 2] = f.z;
          win[4 * v + 3] = f.w;
        }
#pragma unroll
        for (int k = 0; k < kTK; ++k) {
          const float* wr = s_w + ((size_t)k * kTilesCC + c) * npad;
          const float4 wa = reinterpret_cast<const float4*>(wr)[nj];
          const float4 wb = reinterpret_cast<const float4*>(wr)[nj + ng];
#pragma unroll
          for (int r = 0; r < kTilesRT; ++r) {
            const float v = win[r + k];
            acc[r][0] = fmaf(v, wa.x, acc[r][0]);
            acc[r][1] = fmaf(v, wa.y, acc[r][1]);
            acc[r][2] = fmaf(v, wa.z, acc[r][2]);
            acc[r][3] = fmaf(v, wa.w, acc[r][3]);
            acc[r][4] = fmaf(v, wb.x, acc[r][4]);
            acc[r][5] = fmaf(v, wb.y, acc[r][5]);
            acc[r][6] = fmaf(v, wb.z, acc[r][6]);
            acc[r][7] = fmaf(v, wb.w, acc[r][7]);
          }
        }
      }
    }
    __syncthreads();  // stage step & 1 is free for step + 2
  }

  // The tile goes through shared memory (the stages are free) as [channel]
  // [row], so y and dx leave as float4 runs along the rows. acc[r][j]: row
  // 8 tj + r, channel 4 nj + j (j < 4) or 4 (nj + ng) + j - 4.
  const int ldo = cfg.tm + 4;
  float* tile = smem;  // [npad][ldo]
  if (owner) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = j < 4 ? 4 * nj + j : 4 * (nj + ng) + j - 4;
      float4* dst = reinterpret_cast<float4*>(tile + n * ldo + kTilesRT * tj);
      dst[0] = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      dst[1] = make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
    }
  }
  __syncthreads();
  // thread e: channel e / runs, rows 4 (e % runs) .. + 3
  const int runs = cfg.tm / 4, n_e = p.c_out * runs;
  const bool vec = p.out_len % 4 == 0;
  if (kStats) {
    // dout of kU runs loaded before any is used
    constexpr int kU = 4;
    const float* dout = static_cast<const float*>(p.dout);
    float* red = tile + (size_t)npad * ldo;  // [2][c_out * runs]
    for (int e0 = tid; e0 < n_e; e0 += kU * cfg.threads) {
      float gv[kU][4];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = e0 + u * cfg.threads;
        const int n = e / runs, t = t0 + 4 * (e - n * runs);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          gv[u][w] = e < n_e && t + w < p.out_len
                         ? dout[b * p.gb + n * p.gc + (t + w) * p.gt]
                         : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = e0 + u * cfg.threads;
        if (e >= n_e) break;
        const int n = e / runs, t = t0 + 4 * (e - n * runs);
        float sg = 0.f, sbt = 0.f;
        if (t < p.out_len) {
          const float gamma = __ldg(p.sv + n);
          const float beta = __ldg(p.sv + p.c_out + n);
          const float mu = __ldg(p.sv + 2 * p.c_out + n);
          const float r_ = __ldg(p.sv + 3 * p.c_out + n);
          const float4 yv = *reinterpret_cast<const float4*>(
              tile + n * ldo + (t - t0));
          const float ys[4] = {yv.x, yv.y, yv.z, yv.w};
          float* yrow = p.y + ((long long)b * p.c_out + n) * p.out_len;
          if (vec) *reinterpret_cast<float4*>(yrow + t) = yv;
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            if (t + w >= p.out_len) break;
            if (!vec) yrow[t + w] = ys[w];
            float xh;
            const float dz =
                bn_swish_dz(ys[w], gv[u][w], mu, gamma, beta, r_, &xh);
            sg += dz * xh;
            sbt += dz;
          }
        }
        red[e] = sg;
        red[n_e + e] = sbt;
      }
    }
    __syncthreads();
    float* part = p.stats_part + (size_t)blockIdx.x * 2 * p.c_out;
    for (int n = tid; n < p.c_out; n += cfg.threads) {
      float sg = 0.f, sbt = 0.f;
      for (int w = 0; w < runs; ++w) {
        sg += red[n * runs + w];
        sbt += red[n_e + n * runs + w];
      }
      part[n] = sg;
      part[p.c_out + n] = sbt;
    }
  } else {
    float* out = static_cast<float*>(p.out);
    for (int e = tid; e < n_e; e += cfg.threads) {
      const int n = e / runs, t = t0 + 4 * (e - n * runs);
      if (t >= p.out_len) continue;
      const float* src = tile + n * ldo + (t - t0);
      float* orow = out + ((long long)b * p.c_out + n) * p.out_len;
      if (vec) {
        *reinterpret_cast<float4*>(orow + t) =
            *reinterpret_cast<const float4*>(src);
      } else {
        for (int u = 0; u < 4 && t + u < p.out_len; ++u) orow[t + u] = src[u];
      }
    }
  }
}

// dw in f32 register tiles: warp w takes output channels o0 + 8 (w % og) ..
// + 7 and input channels i0 + 32 (w / og) .. + 31, lane l the input channel
// + l, of all 5 taps (40 accumulators). Per 4 rows it
// reads 8 dy float4 (warp-uniform, one broadcast each) and a window of 8 x
// rows (2 float4): 160 FMAs on 10 loads. Both tiles come in by cp.async,
// the next step's in flight. dw_part[chunk][o][i * K + k], the chunk's (b,
// t) summed in order.
constexpr int kDwTT = 64;      // rows a step
constexpr int kDwTLd = kDwTT + 4;  // f32 row stride of both tiles

struct DwTilesCfg {
  int og;     // output-channel groups of 8 (warps along O), at most 8
  int iw;     // warps along I: og * iw <= 8
  int i_blk;  // input channels a block = 32 iw
  int i_tiles, o_tiles, chunks, per_chunk;
  size_t smem;
};

DwTilesCfg dw_tiles_cfg(int B, int O, int I) {
  DwTilesCfg c;
  c.og = (O + 7) / 8;
  if (c.og > kWarps) c.og = kWarps;
  c.iw = kWarps / c.og;
  if (c.iw > (I + 31) / 32) c.iw = (I + 31) / 32;
  c.i_blk = 32 * c.iw;
  c.i_tiles = (I + c.i_blk - 1) / c.i_blk;
  c.o_tiles = (O + 8 * c.og - 1) / (8 * c.og);
  const int tiles = c.i_tiles * c.o_tiles;
  int chunks = (kDwTarget + tiles - 1) / tiles;
  if (chunks > B) chunks = B;
  if (chunks < 1) chunks = 1;
  c.per_chunk = (B + chunks - 1) / chunks;
  c.chunks = (B + c.per_chunk - 1) / c.per_chunk;
  c.smem = 2 * ((size_t)8 * c.og + c.i_blk) * kDwTLd * sizeof(float);
  return c;
}

__global__ void __launch_bounds__(kThreads, 2)
    dw_tiles_kernel(const float* __restrict__ x, long long sb, long long sc,
                    long long st, const float* __restrict__ dyk, int B,
                    int Ti, int To, int O, int I, DwTilesCfg cfg,
                    float* __restrict__ dw_part) {
  extern __shared__ __align__(16) float smem[];
  const int n_o = 8 * cfg.og, n_i = cfg.i_blk, threads = 32 * cfg.og * cfg.iw;
  const size_t buf = ((size_t)n_o + n_i) * kDwTLd;  // one stage: dy, x
  const int tid = threadIdx.x, lane = tid & 31;
  const int wo = (tid >> 5) % cfg.og, wi = (tid >> 5) / cfg.og;
  const int i0 = blockIdx.x * n_i, o0 = blockIdx.y * n_o;
  const int b_lo = blockIdx.z * cfg.per_chunk;
  const int b_hi = min(B, b_lo + cfg.per_chunk);
  const int t_steps = (To + kDwTT - 1) / kDwTT;
  const int n_steps = (b_hi - b_lo) * t_steps;
  const bool by_rows = st == 1;

  // copies of step (b, t0) into stage s: dy [n_o][ld], then x [n_i][ld]
  auto issue = [&](int step, int s) {
    const int b = b_lo + step / t_steps, t0 = (step % t_steps) * kDwTT;
    float* s_dy = smem + s * buf;
    float* s_x = s_dy + (size_t)n_o * kDwTLd;
    const float* xb = x + (long long)b * sb;
    const float* db = dyk + (long long)b * O * To;
    for (int e = tid; e < n_o * kDwTT; e += threads) {
      const int oo = e / kDwTT, u = e - oo * kDwTT;
      const int o = o0 + oo, t = t0 + u;
      const bool valid = o < O && t < To;
      cp_async4(s_dy + oo * kDwTLd + u,
                valid ? db + (long long)o * To + t : db, valid);
    }
    for (int e = tid; e < n_i * kDwTLd; e += threads) {
      const int u = by_rows ? e % kDwTLd : e / n_i;
      const int ii = by_rows ? e / kDwTLd : e % n_i;
      const int i = i0 + ii, t = t0 + u;
      const bool valid = i < I && t < Ti;
      cp_async4(s_x + ii * kDwTLd + u,
                valid ? xb + i * sc + (long long)t * st : xb, valid);
    }
    cp_async_commit();
  };

  float acc[8][kTK];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int k = 0; k < kTK; ++k) acc[q][k] = 0.f;

  if (n_steps > 0) issue(0, 0);
  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) {
      issue(step + 1, (step + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* s_dy = smem + (step & 1) * buf;
    const float* s_x = s_dy + (size_t)n_o * kDwTLd;
#pragma unroll 2
    for (int u0 = 0; u0 < kDwTT; u0 += 4) {
      const float4* xr =
          reinterpret_cast<const float4*>(s_x + (32 * wi + lane) * kDwTLd + u0);
      const float4 f0 = xr[0], f1 = xr[1];
      const float xw[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 d = *reinterpret_cast<const float4*>(
            s_dy + (8 * wo + q) * kDwTLd + u0);
        const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int k = 0; k < kTK; ++k)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            acc[q][k] = fmaf(dv[u], xw[u + k], acc[q][k]);
      }
    }
    __syncthreads();  // stage step & 1 is free for step + 2
  }

  float* part = dw_part + (size_t)blockIdx.z * O * I * kTK;
  const int i = i0 + 32 * wi + lane;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int o = o0 + 8 * wo + q;
    if (o < O && i < I) {
#pragma unroll
      for (int k = 0; k < kTK; ++k)
        part[((size_t)o * I + i) * kTK + k] = acc[q][k];
    }
  }
}

// --------------------------- host side ---------------------------

// The product path of a call: the row kernels, the tensor cores (bf16) or
// the f32 register tiles. Blocks with I, O >= 8 take the tiled products
// (f32 at K = kTK only); the narrow ones (the signal convs, 1 -> 4 and 4 ->
// 16) cannot fill an m16n8k16 tile or an 8-channel register tile and keep
// the row kernels.
enum Path { kPathNone = -1, kPathRows = 0, kPathMma = 1, kPathTiles = 2 };

struct Workspace {
  size_t y, dyk, stats, db, dw, xtm, total;  // byte offsets
  Path path;
  ConvCfg ycfg, dxcfg;  // kPathRows
  DwCfg dwcfg;
  MmaCfg ymma, dxmma;  // kPathMma
  DwMmaCfg dwmma;
  TilesCfg yt, dxt;  // kPathTiles
  DwTilesCfg dwt;
  int stats_blocks, dw_chunks;
};

size_t align256(size_t v) { return (v + 255) / 256 * 256; }

bool shape_ok(int B, int Ti, int I, int O, int K) {
  return B >= 1 && K >= 1 && K <= kMaxK && Ti >= K && I >= 1 && O >= 1 &&
         I <= kMaxC && O <= kMaxC;
}

Workspace layout(int B, int Ti, int I, int O, int K, int elem) {
  Workspace w;
  const int To = Ti - K + 1;
  w.path = kPathNone;
  w.total = 0;
  if (!shape_ok(B, Ti, I, O, K)) return w;
  const bool wide = I >= 8 && O >= 8;
  if (wide && elem == 2) {
    w.ymma = mma_cfg(I, O, K, To, true);
    w.dxmma = mma_cfg(O, I, K, Ti, false);
    w.dwmma = dw_mma_cfg(B, O, I, K);
    if (w.ymma.smem <= kSmemMax && w.dxmma.smem <= kSmemMax) {
      w.path = kPathMma;
      w.stats_blocks = B * w.ymma.tiles;
      w.dw_chunks = w.dwmma.chunks;
    }
  } else if (wide && elem == 4 && K == kTK) {
    w.yt = tiles_cfg(I, O, To, true);
    w.dxt = tiles_cfg(O, I, Ti, false);
    w.dwt = dw_tiles_cfg(B, O, I);
    if (w.yt.ng <= kThreads && w.dxt.ng <= kThreads &&
        w.yt.smem <= kSmemMax && w.dxt.smem <= kSmemMax) {
      w.path = kPathTiles;
      w.stats_blocks = B * w.yt.tiles;
      w.dw_chunks = w.dwt.chunks;
    }
  }
  if (w.path == kPathNone) {
    w.ycfg = pick_conv_cfg(I, O, K, To, true);
    w.dxcfg = pick_conv_cfg(O, I, K, Ti, false);
    w.dwcfg = dw_cfg(B, O, I * K);
    if (w.ycfg.smem <= kSmemMax && w.dxcfg.smem <= kSmemMax &&
        w.dwcfg.smem <= kSmemMax) {
      w.path = kPathRows;
      w.stats_blocks = B * w.ycfg.tiles;
      w.dw_chunks = w.dwcfg.chunks;
    }
  }
  // ordered_sum_runs keeps one float a run in (static-limit) shared memory
  const size_t max_runs = 48 * 1024 / sizeof(float);
  if (w.path != kPathNone &&
      (size_t)(w.stats_blocks + kRun - 1) / kRun > max_runs) {
    w.path = kPathNone;
  }
  if (w.path == kPathNone) return w;
  const size_t n_y = (size_t)B * O * To;
  // dy has O16 channels and x a time-major copy on the tensor-core path
  const bool mma = w.path == kPathMma;
  const size_t n_dyk = (size_t)B * To * (mma ? w.dxmma.cpad : O);
  w.y = 0;
  w.dyk = align256(w.y + n_y * sizeof(float));
  w.xtm = align256(w.dyk + n_dyk * elem);
  w.stats = align256(w.xtm + (mma ? (size_t)B * Ti * w.ymma.cpad * elem : 0));
  w.db = align256(w.stats + (size_t)w.stats_blocks * 2 * O * sizeof(float));
  w.dw = align256(w.db + (size_t)B * O * sizeof(float));
  w.total = align256(w.dw + (size_t)w.dw_chunks * O * I * K * sizeof(float));
  return w;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, bool kStats>
cudaError_t launch_conv(const ConvCfg& cfg, int B, const T* in, long long sb,
                        long long sc, long long st, int in_len, int pad,
                        int c_in, const float4* wp, int K, int c_out,
                        int out_len, const T* dout, long long gb,
                        long long gc, long long gt, const float* sv,
                        float* y, float* stats_part, T* out,
                        cudaStream_t stream) {
  auto kernel = cfg.rt == 2 ? conv_rows_kernel<T, 2, kStats>
                            : conv_rows_kernel<T, 1, kStats>;
  cudaError_t err = set_smem(kernel, cfg.smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * cfg.tiles, kThreads, cfg.smem, stream>>>(
      in, sb, sc, st, in_len, pad, c_in, wp, K, c_out, out_len, cfg, dout,
      gb, gc, gt, sv, y, stats_part, out);
  return cudaGetLastError();
}

// one conv (y with the stats epilogue, or dx) on the rows or tiles kernel
template <typename T, bool kStats>
cudaError_t launch_conv_path(const Workspace& w, int B, const ConvIO& p,
                             cudaStream_t stream) {
  if (w.path == kPathTiles) {
    const TilesCfg& c = kStats ? w.yt : w.dxt;
    cudaError_t err = set_smem(conv_tiles_kernel<kStats>, c.smem);
    if (err != cudaSuccess) return err;
    conv_tiles_kernel<kStats><<<B * c.tiles, c.threads, c.smem, stream>>>(p, c);
    return cudaGetLastError();
  }
  return launch_conv<T, kStats>(
      kStats ? w.ycfg : w.dxcfg, B, static_cast<const T*>(p.in), p.sb, p.sc,
      p.st, p.in_len, p.pad, p.c_in, static_cast<const float4*>(p.w), p.K,
      p.c_out, p.out_len, static_cast<const T*>(p.dout), p.gb, p.gc, p.gt,
      p.sv, p.y, p.stats_part, static_cast<T*>(p.out), stream);
}

cudaError_t launch_sum(const float* partials, float* out, int n_parts,
                       int n_elems, cudaStream_t stream) {
  const int n_runs = (n_parts + kRun - 1) / kRun;
  if (n_runs >= 8) {  // a long walk a thread: spread its runs over a block
    ordered_sum_runs<<<n_elems, 64, n_runs * sizeof(float), stream>>>(
        partials, out, n_parts, n_elems);
  } else {
    launch_ordered_sum<kRun>(partials, out, n_parts, n_elems, stream);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const Workspace& w, const T* x, long long sb,
                      long long sc, long long st, const T* dyk, int B,
                      int Ti, int I, int O, int K, float* dw_part,
                      cudaStream_t stream) {
  const int To = Ti - K + 1;
  cudaError_t err;
  if (w.path == kPathTiles) {
    const DwTilesCfg& d = w.dwt;
    err = set_smem(dw_tiles_kernel, d.smem);
    if (err != cudaSuccess) return err;
    dw_tiles_kernel<<<dim3(d.i_tiles, d.o_tiles, d.chunks), 32 * d.og * d.iw,
                      d.smem, stream>>>(
        reinterpret_cast<const float*>(x), sb, sc, st,
        reinterpret_cast<const float*>(dyk), B, Ti, To, O, I, d, dw_part);
  } else {
    const DwCfg& d = w.dwcfg;
    err = set_smem(dw_kernel<T>, d.smem);
    if (err != cudaSuccess) return err;
    dw_kernel<T><<<dim3(d.j_tiles, d.o_tiles, d.chunks), kThreads, d.smem,
                   stream>>>(x, sb, sc, st, dyk, B, To, O, I, K, d, dw_part);
  }
  return cudaGetLastError();
}

template <bool kStats>
cudaError_t launch_conv_mma(const MmaCfg& c, int B, const ConvIO& p,
                            cudaStream_t stream) {
  const int nt = c.nb / 8;
  auto kernel = nt <= 2   ? conv_mma_kernel<kStats, 2>
                : nt <= 4 ? conv_mma_kernel<kStats, 4>
                          : conv_mma_kernel<kStats, 8>;
  cudaError_t err = set_smem(kernel, c.smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * c.tiles * c.n_tiles, kThreads, c.smem, stream>>>(p, c);
  return cudaGetLastError();
}

// the tensor-core path (bf16): x copied time-major, then the same seven
// steps on time-major operands; dx comes out time-major (B, Ti, I)
int launch_bwd_mma(const Workspace& w, const void* x, long long sb,
                   long long sc, long long st, const void* dout, long long gb,
                   long long gc, long long gt, const void* wp_y,
                   const void* wp_dx, const float* sv, int B, int Ti, int I,
                   int O, int K, void* dx, void* dw, void* db, void* dgb,
                   unsigned char* base, cudaStream_t stream) {
  const int To = Ti - K + 1;
  const int ipad = w.ymma.cpad, opad = w.dxmma.cpad;
  float* y = reinterpret_cast<float*>(base + w.y);
  bf16_bits* dyk = reinterpret_cast<bf16_bits*>(base + w.dyk);
  bf16_bits* xtm = reinterpret_cast<bf16_bits*>(base + w.xtm);
  float* stats = reinterpret_cast<float*>(base + w.stats);
  float* db_part = reinterpret_cast<float*>(base + w.db);
  float* dw_part = reinterpret_cast<float*>(base + w.dw);

  time_major_kernel<<<dim3((Ti + 63) / 64, (ipad + 63) / 64, B), kThreads, 0,
                      stream>>>(static_cast<const bf16_bits*>(x), sb, sc, st,
                                I, Ti, ipad, xtm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const ConvIO py = {xtm,   (long long)Ti * ipad, 1,  ipad, Ti,   0,
                     I,     wp_y,  K,  O,  To,   dout, gb,  gc,
                     gt,    sv,    y,  stats, nullptr};
  err = launch_conv_mma<true>(w.ymma, B, py, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_sum(stats, static_cast<float*>(dgb), w.stats_blocks, 2 * O,
                   stream);
  if (err != cudaSuccess) return (int)err;
  dy_tm_kernel<__nv_bfloat16><<<B, kThreads, 0, stream>>>(
      y, static_cast<const __nv_bfloat16*>(dout), gb, gc, gt, sv,
      static_cast<const float*>(dgb), (float)((long long)B * To), O, opad,
      To, reinterpret_cast<__nv_bfloat16*>(dyk), db_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_sum(db_part, static_cast<float*>(db), B, O, stream);
  if (err != cudaSuccess) return (int)err;
  if (dx != nullptr) {
    const ConvIO pdx = {dyk,     (long long)To * opad, 1, opad, To, K - 1,
                        O,       wp_dx, K,  I,  Ti, nullptr, 0,  0,
                        0,       nullptr, nullptr, nullptr, dx};
    err = launch_conv_mma<false>(w.dxmma, B, pdx, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const DwMmaCfg& d = w.dwmma;
  auto dw_kernel_kc =
      d.kc == kDwMmaKC ? dw_mma_kernel<kDwMmaKC> : dw_mma_kernel<4>;
  err = set_smem(dw_kernel_kc, d.smem);
  if (err != cudaSuccess) return (int)err;
  dw_kernel_kc<<<dim3(d.i_tiles * d.k_chunks, d.o_tiles, d.chunks), kThreads,
                 d.smem, stream>>>(xtm, ipad, dyk, opad, B, Ti, To, O, I, K,
                                   d, dw_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sum(dw_part, static_cast<float*>(dw), w.dw_chunks,
                         O * I * K, stream);
}

template <typename T>
int launch_bwd(const void* x_, long long sb, long long sc, long long st,
               const void* dout_, long long gb, long long gc, long long gt,
               const void* wp_y, const void* wp_dx, const void* sv_, int B,
               int Ti, int I, int O, int K, void* dx_, void* dw, void* db,
               void* dgb, void* ws, void* stream_) {
  const Workspace w = layout(B, Ti, I, O, K, sizeof(T));
  if (w.path == kPathNone) return (int)cudaErrorInvalidValue;
  if (w.path == kPathMma) {
    return launch_bwd_mma(w, x_, sb, sc, st, dout_, gb, gc, gt, wp_y, wp_dx,
                          static_cast<const float*>(sv_), B, Ti, I, O, K, dx_,
                          dw, db, dgb, static_cast<unsigned char*>(ws),
                          (cudaStream_t)stream_);
  }
  const T* x = static_cast<const T*>(x_);
  const float* sv = static_cast<const float*>(sv_);
  cudaStream_t stream = (cudaStream_t)stream_;
  const int To = Ti - K + 1;
  unsigned char* base = static_cast<unsigned char*>(ws);
  float* y = reinterpret_cast<float*>(base + w.y);
  T* dyk = reinterpret_cast<T*>(base + w.dyk);
  float* stats = reinterpret_cast<float*>(base + w.stats);
  float* db_part = reinterpret_cast<float*>(base + w.db);
  float* dw_part = reinterpret_cast<float*>(base + w.dw);

  // 1-2: y, dz and the batch-wide dgamma/dbeta
  const ConvIO py = {x_,    sb,    sc, st, Ti,    0,       I,  wp_y, K, O,
                     To,    dout_, gb, gc, gt,    sv,      y,  stats, nullptr};
  cudaError_t err = launch_conv_path<T, true>(w, B, py, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_sum(stats, static_cast<float*>(dgb), w.stats_blocks, 2 * O,
                   stream);
  if (err != cudaSuccess) return (int)err;
  // 3-4: dy (rounded into T) and db
  dy_kernel<T><<<B, kThreads, 0, stream>>>(
      y, static_cast<const T*>(dout_), gb, gc, gt, sv,
      static_cast<const float*>(dgb), (float)((long long)B * To), O, To, dyk,
      db_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_sum(db_part, static_cast<float*>(db), B, O, stream);
  if (err != cudaSuccess) return (int)err;
  // 5: dx = conv(dy padded by K - 1, w^T flipped), when asked for
  if (dx_ != nullptr) {
    const ConvIO pdx = {dyk,     (long long)O * To, To, 1, To, K - 1, O,
                        wp_dx,   K,  I,  Ti,  nullptr, 0,  0,  0,
                        nullptr, nullptr, nullptr, dx_};
    err = launch_conv_path<T, false>(w, B, pdx, stream);
    if (err != cudaSuccess) return (int)err;
  }
  // 6-7: dw
  err = launch_dw<T>(w, x, sb, sc, st, dyk, B, Ti, I, O, K, dw_part, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sum(dw_part, static_cast<float*>(dw), w.dw_chunks,
                         O * I * K, stream);
}

}  // namespace

extern "C" {

// x (B, I, Ti) and dout (B, O, To) given by their (batch, channel, row)
// element strides, in the compute dtype; wp_y / wp_dx the weights of the y
// and dx convs, packed for the call's path (convbn_bwd_path); sv (4, O) f32
// = gamma, beta, mu, r. Outputs: dx in the compute dtype (null: not
// computed), contiguous (B, Ti, I) on the tensor-core path (convbn_bwd_path
// 1) and (B, I, Ti) otherwise; dw (O, I, K), db (O), dgb (2, O) = dgamma,
// dbeta, all f32; ws: convbn_bwd_workspace_bytes of scratch. Returns the
// cudaError_t of the launches (0 = launched).
int convbn_bwd_f32(const void* x, long long sb, long long sc, long long st,
                   const void* dout, long long gb, long long gc,
                   long long gt, const void* wp_y, const void* wp_dx,
                   const void* sv, int B, int Ti, int I, int O, int K,
                   void* dx, void* dw, void* db, void* dgb, void* ws,
                   void* stream) {
  return launch_bwd<float>(x, sb, sc, st, dout, gb, gc, gt, wp_y, wp_dx, sv,
                           B, Ti, I, O, K, dx, dw, db, dgb, ws, stream);
}

int convbn_bwd_bf16(const void* x, long long sb, long long sc, long long st,
                    const void* dout, long long gb, long long gc,
                    long long gt, const void* wp_y, const void* wp_dx,
                    const void* sv, int B, int Ti, int I, int O, int K,
                    void* dx, void* dw, void* db, void* dgb, void* ws,
                    void* stream) {
  return launch_bwd<__nv_bfloat16>(x, sb, sc, st, dout, gb, gc, gt, wp_y,
                                   wp_dx, sv, B, Ti, I, O, K, dx, dw, db, dgb,
                                   ws, stream);
}

long long convbn_bwd_workspace_bytes(int B, int Ti, int I, int O, int K,
                                     int elem) {
  return (long long)layout(B, Ti, I, O, K, elem).total;
}

// the path a call takes (0 rows, 1 mma.sync bf16, 2 f32 register tiles),
// or -1 where no kernel takes the shape; elem is the compute dtype's size
int convbn_bwd_path(int B, int Ti, int I, int O, int K, int elem) {
  return (int)layout(B, Ti, I, O, K, elem).path;
}

// the packed weights' shape for path 1 or 2: (K, n, c) for mma.sync,
// (K, c, n) for the register tiles, as dims[0] = n (output channels) and
// dims[1] = c (input channels) of a conv from c_in to c_out
void convbn_bwd_pack_dims(int path, int c_in, int c_out, int K,
                          int* dims) {
  if (path == kPathMma) {
    const MmaCfg c = mma_cfg(c_in, c_out, K, 1, false);
    dims[0] = c.npad;
    dims[1] = c.cpad;
  } else {
    const TilesCfg c = tiles_cfg(c_in, c_out, 1, false);
    dims[0] = c.npad;
    dims[1] = c.cpad;
  }
}

int convbn_bwd_max_k(void) { return kMaxK; }
int convbn_bwd_max_c(void) { return kMaxC; }

const char* convbn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
