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
// dgamma/dbeta barrier becomes a launch boundary, and on this card bytes are
// cheaper than a second conv, so y is computed once and stored:
//   1. conv_rows_kernel<kStats>: y = conv(x, w) for a (batch element, row
//      tile), written as f32 (B, O, To); dz in the epilogue, each block's
//      dgamma/dbeta partial summed in a fixed order;
//   2. ordered_sum (or ordered_sum_runs): dgamma, dbeta = the partials
//      summed in block order;
//   3. dy_kernel: dy from y and dout (elementwise), rounded to T into
//      (B, O, To); each batch element's db partial;
//   4. ordered_sum: db;
//   5. conv_rows_kernel (no stats): dx = conv(dy zero-padded by K - 1 rows,
//      w transposed and flipped), rounded once to T; skipped when the caller
//      needs no dx;
//   6. dw_kernel: dw as a split-K product over (b, t) chunks, each block a
//      (o tile, (i, k) tile, chunk) partial;
//   7. ordered_sum: dw.
// No atomics anywhere: every cross-block sum runs in block order, so a call
// repeats bit for bit.
//
// conv_rows_kernel maps a warp's lanes onto consecutive output rows and its
// warps onto groups of 4 output channels (a thread holds RT rows x 4
// channels in registers): reads of the staged input tile (shared memory,
// channel-major with an odd row stride) are conflict-free and the weight
// loads are warp-uniform float4 reads through L1 (the weight stack of the
// widest block, 5 x 128 x 64 f32 = 160 KB, does not fit beside the input
// tile). Tiny channel counts (I = 1, O = 4) put more row threads on a group,
// so the block stays full. The input may have any batch and channel strides
// (the port's activations are channels-last views of (B, C, T) storage); the
// staging loop walks rows or channels, whichever is contiguous.
//
// Bounds at the main path's widest stride-1 block (merge_conv1: B = 2048,
// Ti = 128, I = 128, O = 64, K = 5, f32): three products of 2*B*To*I*O*K =
// 20.8 GFLOP (y once, dx, dw) = 62.4 GFLOP at 67 TFLOP/s FP32 -> 0.93 ms;
// x + dout + dx = 333 MB -> 0.10 ms. So the FP32 pipes bound it; this kernel
// runs its products on them (no tensor cores) with one shared and one L1
// load per 4-8 FMAs, which keeps it well above that floor. Tensor-core
// (mma/wgmma) products are the later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
#pragma unroll 4
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

// sum over parts of partials[part][e], in part order: runs of kRun parts
// summed apart, then the runs (short chains keep the f32 error down)
constexpr int kRun = 64;

__global__ void ordered_sum(const float* __restrict__ partials,
                            float* __restrict__ out, int n_parts,
                            int n_elems) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elems) return;
  float s = 0.f;
  for (int p0 = 0; p0 < n_parts; p0 += kRun) {
    const int p1 = min(n_parts, p0 + kRun);
    float run = 0.f;
    for (int p = p0; p < p1; ++p) run += partials[(size_t)p * n_elems + e];
    s += run;
  }
  out[e] = s;
}

// ordered_sum for many parts: one block an element, each thread a run, the
// runs then summed in order by one thread (the same sums as ordered_sum)
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
// db partial (the f32 sum of the unrounded dy): db_part[b][o]
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dy_kernel(const float* __restrict__ y, const T* __restrict__ dout,
              long long gb, long long gc, long long gt,
              const float* __restrict__ sv, const float* __restrict__ dgb,
              float n_total, int O, int To, T* __restrict__ dyk,
              float* __restrict__ db_part) {
  extern __shared__ float red[];  // [kWarps][O]
  const int tid = threadIdx.x, b = blockIdx.x;
  for (int o = 0; o < O; ++o) {
    const float gamma = __ldg(sv + o), beta = __ldg(sv + O + o);
    const float mu = __ldg(sv + 2 * O + o), r = __ldg(sv + 3 * O + o);
    const float gr = gamma * r;
    const float mean_dbeta = __ldg(dgb + O + o) / n_total;
    const float mean_dgamma = __ldg(dgb + o) / n_total;
    const long long row = ((long long)b * O + o) * To;
    float part = 0.f;
    for (int t = tid; t < To; t += kThreads) {
      float xh;
      const float dz =
          bn_swish_dz(y[row + t], to_f32(dout[b * gb + o * gc + t * gt]), mu,
                      gamma, beta, r, &xh);
      const float dy = gr * (dz - mean_dbeta - xh * mean_dgamma);
      dyk[row + t] = from_f32<T>(dy);
      part += dy;
    }
    part = warp_sum(part);
    if ((tid & 31) == 0) red[(tid / 32) * O + o] = part;
  }
  __syncthreads();
  for (int o = tid; o < O; o += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * O + o];
    db_part[(size_t)b * O + o] = s;
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

// --------------------------- host side ---------------------------

struct Workspace {
  size_t y, dyk, stats, db, dw, total;  // byte offsets
  ConvCfg ycfg, dxcfg;
  DwCfg dwcfg;
  int stats_blocks;
};

size_t align256(size_t v) { return (v + 255) / 256 * 256; }

Workspace layout(int B, int Ti, int I, int O, int K, int elem) {
  Workspace w;
  const int To = Ti - K + 1;
  w.ycfg = pick_conv_cfg(I, O, K, To, true);
  w.dxcfg = pick_conv_cfg(O, I, K, Ti, false);
  w.dwcfg = dw_cfg(B, O, I * K);
  w.stats_blocks = B * w.ycfg.tiles;
  const size_t n_y = (size_t)B * O * To;
  w.y = 0;
  w.dyk = align256(w.y + n_y * sizeof(float));
  w.stats = align256(w.dyk + n_y * elem);
  w.db = align256(w.stats + (size_t)w.stats_blocks * 2 * O * sizeof(float));
  w.dw = align256(w.db + (size_t)B * O * sizeof(float));
  w.total = align256(w.dw + (size_t)w.dwcfg.chunks * O * I * K *
                                sizeof(float));
  return w;
}

bool fits(int B, int Ti, int I, int O, int K) {
  if (B < 1 || K < 1 || K > kMaxK || Ti < K || I < 1 || O < 1 ||
      I > kMaxC || O > kMaxC) {
    return false;
  }
  const Workspace w = layout(B, Ti, I, O, K, 4);
  // ordered_sum_runs keeps one float a run in (static-limit) shared memory
  const size_t max_runs = 48 * 1024 / sizeof(float);
  if ((size_t)(w.stats_blocks + kRun - 1) / kRun > max_runs) return false;
  return w.ycfg.smem <= kSmemMax && w.dxcfg.smem <= kSmemMax &&
         w.dwcfg.smem <= kSmemMax && (size_t)kWarps * O * 4 <= kSmemMax;
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
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cfg.smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * cfg.tiles, kThreads, cfg.smem, stream>>>(
      in, sb, sc, st, in_len, pad, c_in, wp, K, c_out, out_len, cfg, dout,
      gb, gc, gt, sv, y, stats_part, out);
  return cudaGetLastError();
}

cudaError_t launch_sum(const float* partials, float* out, int n_parts,
                       int n_elems, cudaStream_t stream) {
  const int n_runs = (n_parts + kRun - 1) / kRun;
  if (n_runs >= 8) {  // a long walk a thread: spread its runs over a block
    ordered_sum_runs<<<n_elems, 64, n_runs * sizeof(float), stream>>>(
        partials, out, n_parts, n_elems);
  } else {
    ordered_sum<<<(n_elems + 255) / 256, 256, 0, stream>>>(partials, out,
                                                           n_parts, n_elems);
  }
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x_, long long sb, long long sc, long long st,
               const void* dout_, long long gb, long long gc, long long gt,
               const void* wp_y, const void* wp_dx, const void* sv_, int B,
               int Ti, int I, int O, int K, void* dx_, void* dw, void* db,
               void* dgb, void* ws, void* stream_) {
  if (!fits(B, Ti, I, O, K)) return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(x_);
  const T* dout = static_cast<const T*>(dout_);
  const float* sv = static_cast<const float*>(sv_);
  cudaStream_t stream = (cudaStream_t)stream_;
  const int To = Ti - K + 1;
  const Workspace w = layout(B, Ti, I, O, K, sizeof(T));
  unsigned char* base = static_cast<unsigned char*>(ws);
  float* y = reinterpret_cast<float*>(base + w.y);
  T* dyk = reinterpret_cast<T*>(base + w.dyk);
  float* stats = reinterpret_cast<float*>(base + w.stats);
  float* db_part = reinterpret_cast<float*>(base + w.db);
  float* dw_part = reinterpret_cast<float*>(base + w.dw);

  // 1-2: y, dz and the batch-wide dgamma/dbeta
  cudaError_t err = launch_conv<T, true>(
      w.ycfg, B, x, sb, sc, st, Ti, 0, I,
      static_cast<const float4*>(wp_y), K, O, To, dout, gb, gc, gt, sv, y,
      stats, nullptr, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_sum(stats, static_cast<float*>(dgb), w.stats_blocks, 2 * O,
                   stream);
  if (err != cudaSuccess) return (int)err;
  // 3-4: dy (rounded into T) and db
  const size_t dy_smem = (size_t)kWarps * O * sizeof(float);
  err = cudaFuncSetAttribute(dy_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dy_smem);
  if (err != cudaSuccess) return (int)err;
  dy_kernel<T><<<B, kThreads, dy_smem, stream>>>(
      y, dout, gb, gc, gt, sv, static_cast<const float*>(dgb),
      (float)((long long)B * To), O, To, dyk, db_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_sum(db_part, static_cast<float*>(db), B, O, stream);
  if (err != cudaSuccess) return (int)err;
  // 5: dx = conv(dy padded by K - 1, w^T flipped), when asked for
  if (dx_ != nullptr) {
    err = launch_conv<T, false>(
        w.dxcfg, B, dyk, (long long)O * To, To, 1, To, K - 1, O,
        static_cast<const float4*>(wp_dx), K, I, Ti, nullptr, 0, 0, 0,
        nullptr, nullptr, nullptr, static_cast<T*>(dx_), stream);
    if (err != cudaSuccess) return (int)err;
  }
  // 6-7: dw
  const DwCfg& d = w.dwcfg;
  err = cudaFuncSetAttribute(dw_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)d.smem);
  if (err != cudaSuccess) return (int)err;
  dw_kernel<T><<<dim3(d.j_tiles, d.o_tiles, d.chunks), kThreads, d.smem,
                 stream>>>(x, sb, sc, st, dyk, B, To, O, I, K, d, dw_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sum(dw_part, static_cast<float*>(dw), d.chunks,
                         O * I * K, stream);
}

}  // namespace

extern "C" {

// x (B, I, Ti) and dout (B, O, To) given by their (batch, channel, row)
// element strides, in the compute dtype; wp_y / wp_dx the packed f32
// weights of the y and dx convs; sv (4, O) f32 = gamma, beta, mu, r.
// Outputs: dx (B, I, Ti) contiguous in the compute dtype (null: not
// computed), dw (O, I, K), db (O), dgb (2, O) = dgamma, dbeta, all f32;
// ws: convbn_bwd_workspace_bytes of scratch. Returns the cudaError_t of the
// launches (0 = launched).
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

int convbn_bwd_fits(int B, int Ti, int I, int O, int K) {
  return fits(B, Ti, I, O, K) ? 1 : 0;
}

int convbn_bwd_max_k(void) { return kMaxK; }
int convbn_bwd_max_c(void) { return kMaxC; }

const char* convbn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
