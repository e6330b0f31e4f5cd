// K3, the training LSTM backward, at the widths the main-shape kernels do not
// take (every 1 <= C <= 128, 1 <= H <= 128 that kernels/lstm.py::route sends
// here), f32 and bf16, sm_90a.
//
// Replaces, at those widths, remora_tpu/kernels/pallas_lstm.py::_bwd_kernel
// (launched by _bwd_call): the reverse-time backward of one LSTM layer over x
// (T, B, C) that recomputes the gates from the saved h and c, writes dx and
// sums dW_aug = sum_t [x_t ; h_{t-1} ; 1]^T . dgates_t. The forward at these
// widths is lstm_wide.cu.
//
// Three parts, as lstm_bwd_mma.cu does at the main shape (the plain twins in
// kernels/lstm.py: lstm_bwd_gates_reference, lstm_bwd_recurrence_reference,
// lstm_bwd_products_reference):
//   (a) Z = [x_t ; h_{t-1}] . W_aug[:C+H] + b for every (t, row) at once, f32;
//   (b) the reverse recurrence, the only serial part: dgates_t from the gate
//       pre-activations, c and dh_t, then dh_{t-1} = dgates_t . W_h^T;
//   (c) dx = dgates . W_x^T, rounded once, and dW_aug = [x ; h_{t-1}]^T .
//       dgates over fixed chunks of kDwChunkRows rows into f32 partials (the
//       bias row, the dgates column sums, taken by the chunk's first row
//       tile), which ordered_sum (mma_sm90.cuh) sums in chunk order: no
//       atomics, and a repeated call gives the same bits.
//
// What bounds it (T = 124, B = 2048, C = H = 96; H100 SXM: 67 TFLOP/s FP32,
// 989 bf16, 3.35 TB/s): f32 is operations-bound, 112 GFLOP (1.68 ms): the
// gate recompute 37.5, the recurrence's dgates . W_h^T 18.7, dx 18.7, dW
// 37.6. bf16 is bytes-bound by this plan: Z written and read in f32 (195 MB
// each way), dgates written once and read twice, x and hs read twice, ~0.5
// ms in all. The serial chain is T steps of the recurrence.
//
// What the design does about it:
//   wide_rec_cluster_kernel, (b): a cluster of 2 CTAs owns 32 batch rows, so
//     B = 2048 is 64 clusters on 128 SMs, one wave. CTA r owns hidden units
//     [r hh, r hh + hh) (hh = ceil(H / 2) rounded up to 8): their gate math,
//     and W_h^T's rows of its own 4 hh gate columns, all H units wide, held in
//     shared memory for the whole walk (73.7 KB f32 at H = 96, 128 KB at
//     128; half in bf16). A step: thread (row, 8 units) does the gate math of
//     its own units (dgates rounded to the dtype once) and stores them to
//     device memory and into the CTA's shared dgates tile (f32: k-major, row
//     chunks swizzled by k, so neither these stores nor the product's float4
//     reads conflict); then the CTA's partial dh_{t-1} over its own gate
//     columns, for all H units: f32 as 8-row x 4 NQ-unit FFMA register tiles
//     a lane, the CTA's k split over warps; bf16 on mma.sync.m16n8k16 (f32
//     accumulators, W_h^T as [unit][k] for ldmatrix). The splits' partials
//     meet in shared memory; each thread sums them in split order for its
//     own units (kept in registers) and for the partner's units, which it
//     stores into the partner's double-buffered receive tile through
//     distributed shared memory; one cluster barrier a step
//     (barrier.cluster arrive.release / wait.acquire) publishes them. The
//     next step's Z, c and dh are loaded at the step's head (predicated
//     volatile loads, first read at the step's end) and its activations
//     computed between the barrier's arrive and wait, off the chain. Every
//     CTA of a cluster runs every step and every barrier, whatever rows it
//     holds; the launch checks that the card can hold the cluster
//     (cudaOccupancyMaxActiveClusters) and is refused otherwise. On an H100
//     at 700 W a step takes ~9.8 us in f32 at C = H = 96 against its 2.3 us
//     FFMA floor: the product ~4.2 us, the rest fixed work on 8 warps
//     (chip_lstm_bwd_variants.py --wide splits it).
//   wide_prod_f32_kernel, (a) and (c): block tiles of up to 128 x 128, a
//     thread 2MC x 2NC outputs (8 x 8 at most) from float2 chunks 32 apart;
//     the variable dimension's tile (dx's N = C, the gates' N = 4H: 32 NC
//     wide; dW's M = C + H: 32, 64 or 128 rows, since a 96-row tile spills)
//     is sized to the dimension, so dx at C = 96 and dW at C + H = 192 and
//     256 compute no padding. Operands staged by 16-byte cp.async into a
//     3-stage ring, 32 k a stage, one barrier a stage; [x ; h_{t-1}]
//     resolved once per 16-byte chunk (x, h or zero), a per-element edge
//     path where C, H or a pointer are not 16-byte multiples. Epilogues
//     store float2 (dx, whose C may be odd, by element), the bias held in
//     registers.
//   wide_prod_bf16_kernel: the same staging, 64 k a stage, on mma.sync
//     (128 x 128 tiles, 8 warps of 64 x 32, ldmatrix from padded tiles).
//
// Numerics are the plain twins' (kernels/lstm.py): f32 sums of products of
// the dtype's values; dgates rounded to the dtype once before every product;
// dx rounded once; dh and dc carried in f32; dW in f32. dh_{t-1} sums the
// two CTAs' partials (each the sum of its splits in a fixed order), so a
// repeated call gives the same bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxC = 128;
constexpr int kMaxH = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 2;          // CTAs a cluster in (b)
constexpr int kRows = 32;            // batch rows a cluster in (b)
constexpr int kDwChunkRows = 2048;   // dW's K rows a chunk
constexpr int kStages = 3;           // the products' cp.async ring
constexpr int kTile = 128;           // the products' largest tile side
constexpr size_t kSmemMax = 232448;  // 227 KB a block can use

static_assert(kRows == 4 * kWarps, "(b): warp w does rows 4w .. 4w + 3");

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

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

// 1 / (1 + e^-z): the reciprocal rounded to nearest is IEEE 1.0f / x's
// result, without the division's slow-path branches
__device__ __forceinline__ float sigmoid(float z) {
  return __frcp_rn(1.0f + expf(-z));
}

// v = *p where ok (v keeps its value elsewhere): a read-only device load
// kept where it is written and predicated in place (volatile: the compiler
// neither sinks it toward its use nor selects on its result), so a step's
// loads for the next step stay in flight until the step's end uses them
__device__ __forceinline__ void load_now(float& v, const float* p, bool ok) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
      "@q ld.global.nc.f32 %0, [%1];\n}\n"
      : "+f"(v)
      : "l"(p), "r"((int)ok));
}
__device__ __forceinline__ void load_now(bf16_bits& v, const bf16_bits* p,
                                         bool ok) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
      "@q ld.global.nc.u16 %0, [%1];\n}\n"
      : "+h"(v)
      : "l"(p), "r"((int)ok));
}

// the cluster barrier in two halves: arrive (release: this CTA's writes to
// its partner's shared memory are published) and wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------- (b) the reverse recurrence ----------------------

// (b)'s shapes and shared memory. Regions: the W_h^T slice; the dgates tile,
// which the splits' partials reuse once the product has read it; the
// receive tiles of the partner's partial sums, two buffers.
struct RecCfg {
  int hh;      // hidden units a CTA (a multiple of 8)
  int kl;      // the CTA's gate columns, 4 hh: the product's depth
  int hp;      // the product's N: H padded (f32 ncols x 32 NQ; bf16 to 16)
  int ncols;   // f32: warp columns across hp
  int nsplit;  // f32: k splits (kWarps / ncols); bf16: 1
  int ldw;     // W slice row (elements): f32 [kl][hp], bf16 [hp][kl + 8]
  int ldd;     // dgates row: f32 [kl][32], bf16 [32][kl + 8]
  int ldp;     // a split partial's row (floats), = 8 mod 32
  int ldr;     // a receive tile's row (floats), = 8 mod 32
  size_t d_off, r_off, smem;
};

template <typename T>
RecCfg rec_cfg(int H, int nq) {
  RecCfg c;
  c.hh = round_up((H + 1) / 2, 8);
  c.kl = 4 * c.hh;
  if (sizeof(T) == 4) {
    const int span = 32 * nq;
    c.ncols = (H + span - 1) / span;
    c.nsplit = kWarps / c.ncols;
    c.hp = c.ncols * span;
    c.ldw = c.hp;
    c.ldd = kRows;
  } else {
    c.ncols = 1;
    c.nsplit = 1;
    c.hp = round_up(H, 16);
    c.ldw = c.kl + 8;
    c.ldd = c.kl + 8;
  }
  c.ldp = round_up(c.hp, 32) + 8;
  c.ldr = round_up(c.hh, 32) + 8;
  const size_t w_bytes = sizeof(T) == 4 ? (size_t)c.kl * c.ldw * 4
                                        : (size_t)c.hp * c.ldw * 2;
  const size_t d_bytes = sizeof(T) == 4 ? (size_t)c.kl * c.ldd * 4
                                        : (size_t)kRows * c.ldd * 2;
  const size_t p_bytes = (size_t)c.nsplit * kRows * c.ldp * 4;
  c.d_off = round_up((int)w_bytes, 16);
  c.r_off = c.d_off + round_up((int)(d_bytes > p_bytes ? d_bytes : p_bytes),
                               16);
  c.smem = c.r_off + (size_t)2 * kRows * c.ldr * 4;
  return c;
}

// The f32 dgates tile: element (k, row) of a [kl][32] tile whose 4-row
// chunks are swizzled by k, so the gate phase's stores (8 k x 4 rows a warp)
// and the product's float4 reads (one k, 8 rows a lane) hit distinct banks.
__device__ __forceinline__ int dsw(int k, int row) {
  return k * kRows + ((((row >> 2) ^ (k & 7))) << 2) + (row & 3);
}

// The CTA's partial dh over its own gate columns, for all hp units, f32:
// warp w takes units [col 32 NQ, +32 NQ) (col = w % ncols) over its k split
// (w / ncols); lane (rt, ut) rows 8 rt .. 8 rt + 7 and units 32 j + 4 ut ..
// +3 (j < NQ) of the column. The tile goes to split partial w / ncols.
template <int kNQ>
__device__ __forceinline__ void rec_product(const float* ws, const float* ds,
                                            float* ps, const RecCfg& cfg) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = warp % cfg.ncols, split = warp / cfg.ncols;
  const int rt = lane >> 3, ut = lane & 7;
  const int kper = cfg.kl / cfg.nsplit;
  const int k0 = split * kper;
  const int u0 = col * 32 * kNQ + 4 * ut;
  float acc[8][4 * kNQ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kNQ; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int k = k0; k < k0 + kper; ++k) {
    const float* drow = ds + k * kRows;
    const int sw = k & 7;
    const float4 a0 = *reinterpret_cast<const float4*>(
        drow + (((2 * rt) ^ sw) << 2));
    const float4 a1 = *reinterpret_cast<const float4*>(
        drow + (((2 * rt + 1) ^ sw) << 2));
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float* wrow = ws + k * cfg.ldw + u0;
#pragma unroll
    for (int j = 0; j < kNQ; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(wrow + 32 * j);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][4 * j + e] = fmaf(av[i], bv[e], acc[i][4 * j + e]);
    }
  }
  __syncthreads();  // every warp has read the dgates tile ps reuses
  float* pt = ps + (size_t)split * kRows * cfg.ldp;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kNQ; ++j)
      *reinterpret_cast<float4*>(pt + (8 * rt + i) * cfg.ldp + u0 + 32 * j) =
          make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2],
                      acc[i][4 * j + 3]);
}

// The same in bf16 on mma.sync: warp (wm, wn) takes m16 tile wm (rows 16 wm
// .. +15) and the n16 unit groups wn and wn + 4 over all kl.
__device__ __forceinline__ void rec_product_bf16(const bf16_bits* ws,
                                                 const bf16_bits* ds,
                                                 float* ps,
                                                 const RecCfg& cfg) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int np16 = cfg.hp / 16;
  float acc[2][2][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[p][h][v] = 0.f;
  for (int kk = 0; kk < cfg.kl; kk += 16) {
    uint32_t a[4];
    ldsm_x4(a, smem_u32(ds + (wm * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 cfg.ldd + kk + (lane >> 4) * 8));
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int grp = wn + 4 * p;
      if (grp < np16) {
        uint32_t r[4];
        const int n = grp * 16 + (lane & 7) + (lane >> 4) * 8;
        ldsm_x4(r, smem_u32(ws + n * cfg.ldw + kk + ((lane >> 3) & 1) * 8));
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_16816(acc[p][0], a, b0);
        mma_16816(acc[p][1], a, b1);
      }
    }
  }
  __syncthreads();  // every warp has read the dgates tile ps reuses
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int grp = wn + 4 * p;
    if (grp >= np16) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int row = wm * 16 + g + 8 * s;
        const int n = grp * 16 + h * 8 + 2 * q;
        *reinterpret_cast<float2*>(ps + row * cfg.ldp + n) =
            make_float2(acc[p][h][2 * s], acc[p][h][2 * s + 1]);
      }
  }
}

// One cluster of kCluster CTAs per kRows batch rows walks t = T-1 .. 0.
// Thread (warp w, lane = rq + 4 uo) owns row 4 w + rq and the units 8 i + uo
// (i < ne) of its CTA: their gate math, dc carry and dh sums.
template <typename T, int kNQ, int kNE>
__global__ void __launch_bounds__(kThreads, 1)
    wide_rec_cluster_kernel(const float* __restrict__ z,
                            const T* __restrict__ cs,
                            const T* __restrict__ dhs,
                            const T* __restrict__ w_ht, T* __restrict__ dg,
                            int n_steps, int B, int H, RecCfg cfg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  T* ws = reinterpret_cast<T*>(smem_raw);
  T* ds = reinterpret_cast<T*>(smem_raw + cfg.d_off);
  float* ps = reinterpret_cast<float*>(smem_raw + cfg.d_off);
  float* rs = reinterpret_cast<float*>(smem_raw + cfg.r_off);
  float* rs_partner = cluster.map_shared_rank(rs, rank ^ 1);

  const int G = 4 * H, hh = cfg.hh, kl = cfg.kl, ne = hh / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rq = lane & 3, uo = lane >> 2;
  const int row = 4 * warp + rq;
  const int base = rank * hh, pbase = (rank ^ 1) * hh;
  const long long brow = (long long)(blockIdx.x / kCluster) * kRows + row;
  const bool row_ok = brow < B;

  // the W_h^T slice: local gate column k = gate hh + j is W_h^T's row
  // gate H + base + j (zero past H)
  if constexpr (sizeof(T) == 4) {
    for (int e = tid; e < kl * cfg.ldw; e += kThreads) {
      const int k = e / cfg.ldw, u = e - k * cfg.ldw;
      const int unit = base + k % hh;
      ws[e] = (u < H && unit < H)
                  ? w_ht[(size_t)((k / hh) * H + unit) * H + u]
                  : T(0);
    }
  } else {
    for (int e = tid; e < kl * cfg.hp; e += kThreads) {
      const int k = e / cfg.hp, u = e - k * cfg.hp;
      const int unit = base + k % hh;
      ws[u * cfg.ldw + k] = (u < H && unit < H)
                                ? w_ht[(size_t)((k / hh) * H + unit) * H + u]
                                : T(0);
    }
  }
  cluster.sync();  // the partner runs (its shared memory exists) and the
                   // W slice is in place

  bool ok[kNE];
#pragma unroll
  for (int i = 0; i < kNE; ++i)
    ok[i] = row_ok && i < ne && base + 8 * i + uo < H;

  // a step's inputs as loaded: Z's four gates, c_{t-1} and dh_t (zero
  // where !ok)
  float zn[kNE][4];
  T cpn[kNE], dhn[kNE];
  auto fetch = [&](int t) {
    const long long m = (long long)t * B + brow;
#pragma unroll
    for (int i = 0; i < kNE; ++i) {
      const int u = base + 8 * i + uo;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        zn[i][g] = 0.f;
        load_now(zn[i][g], z + m * G + g * H + u, ok[i]);
      }
      cpn[i] = dhn[i] = T(0);
      load_now(cpn[i], cs + (m - B) * H + u, ok[i] && t > 0);
      load_now(dhn[i], dhs + m * H + u, ok[i]);
    }
  };
  // the current step's carry-independent terms: the gate activations and
  // tanh(c_t), computed off the chain (the step before, while the cluster
  // barrier completes); c_{t-1} and dh_t
  float act[kNE][5], cpc[kNE], dhc[kNE];
  auto activate = [&](const float(&c)[kNE]) {
#pragma unroll
    for (int i = 0; i < kNE; ++i) {
      act[i][0] = sigmoid(zn[i][0]);
      act[i][1] = sigmoid(zn[i][1]);
      act[i][2] = tanhf(zn[i][2]);
      act[i][3] = sigmoid(zn[i][3]);
      act[i][4] = tanhf(c[i]);
      cpc[i] = widen(cpn[i]);
      dhc[i] = widen(dhn[i]);
    }
  };
  float dcc[kNE], own[kNE];
  if (n_steps > 0) {
    const long long m = (long long)(n_steps - 1) * B + brow;
    float c_last[kNE];
#pragma unroll
    for (int i = 0; i < kNE; ++i)
      c_last[i] = ok[i] ? widen(__ldg(cs + m * H + base + 8 * i + uo)) : 0.f;
    fetch(n_steps - 1);
    activate(c_last);
  }
#pragma unroll
  for (int i = 0; i < kNE; ++i) dcc[i] = own[i] = 0.f;

  for (int t = n_steps - 1; t >= 0; --t) {
    if (t > 0) fetch(t - 1);  // in flight during the step
    const float* rcv = rs + (size_t)(t & 1) * kRows * cfg.ldr + row * cfg.ldr;
    const long long m = (long long)t * B + brow;
#pragma unroll
    for (int i = 0; i < kNE; ++i) {
      if (i >= ne) continue;
      const int j = 8 * i + uo;  // the unit's index in the CTA
      float q[4] = {0.f, 0.f, 0.f, 0.f};
      if (ok[i]) {
        const float ig = act[i][0], fg = act[i][1], gg = act[i][2];
        const float og = act[i][3], tanh_c = act[i][4];
        const float dh_c = t < n_steps - 1 ? own[i] + rcv[j] : 0.f;
        const float dh = dhc[i] + dh_c;
        const float dc = dcc[i] + dh * og * (1.0f - tanh_c * tanh_c);
        q[0] = rounded<T>(dc * gg * ig * (1.0f - ig));
        q[1] = rounded<T>(dc * cpc[i] * fg * (1.0f - fg));
        q[2] = rounded<T>(dc * ig * (1.0f - gg * gg));
        q[3] = rounded<T>(dh * tanh_c * og * (1.0f - og));
        dcc[i] = dc * fg;
        T* dgm = dg + m * G + base + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) dgm[g * H] = narrow<T>(q[g]);
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if constexpr (sizeof(T) == 4) {
          ds[dsw(g * hh + j, row)] = q[g];
        } else {
          ds[row * cfg.ldd + g * hh + j] = narrow<T>(q[g]);
        }
      }
    }
    if (t == 0) break;
    __syncthreads();  // the dgates tile is complete
    if constexpr (sizeof(T) == 4) {
      rec_product<kNQ>(ws, ds, ps, cfg);
    } else {
      rec_product_bf16(ws, ds, ps, cfg);
    }
    __syncthreads();  // the split partials are complete
    // own units' sums stay in registers; the partner's go to its receive
    // tile for step t - 1
    float* dst = rs_partner + (size_t)((t - 1) & 1) * kRows * cfg.ldr +
                 row * cfg.ldr;
#pragma unroll
    for (int i = 0; i < kNE; ++i) {
      if (i >= ne) continue;
      const int j = 8 * i + uo;
      float mine = 0.f, theirs = 0.f;
      for (int s = 0; s < cfg.nsplit; ++s) {
        const float* pr = ps + ((size_t)s * kRows + row) * cfg.ldp;
        mine += pr[base + j];
        theirs += pr[pbase + j];
      }
      own[i] = mine;
      dst[j] = theirs;
    }
    cluster_arrive();
    float c_prev[kNE];  // c_{t-1}: step t - 1's c
#pragma unroll
    for (int i = 0; i < kNE; ++i) c_prev[i] = cpc[i];
    activate(c_prev);  // step t - 1's, while the partner's sums land
    cluster_wait();  // the partner's sums have landed; the tiles are free
  }
  cluster.sync();  // no CTA leaves while its partner may touch its tiles
}

// ------------------- (a), (c): the products off the chain -------------------

enum Op { kGates, kDx, kDw };

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
    *k1 = op == kGates ? p.C + p.H : 4 * p.H;
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
  if (op == kGates) {
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
// Two blocks an SM (128 registers) but for dx's full 128-column tile, whose
// 8 x 8 thread tile needs more and runs one block an SM unspilled.
template <Op op, int MC, int NC>
__global__ void __launch_bounds__(kThreads, op == kDx && NC == 4 ? 1 : 2)
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
          op == kGates && n < N ? p.w[(long long)(p.C + p.H) * G + n] : 0.f;
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

bool fits(int C, int H) {
  return C >= 1 && C <= kMaxC && H >= 1 && H <= kMaxH;
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

// (b) at H's class: the f32 register tile (NQ float4 chunks of units) and
// the units a thread (NE = hh / 8 at most)
template <typename T, int kNQ, int kNE>
cudaError_t launch_rec_at(const float* z, const T* cs, const T* dhs,
                          const T* w_ht, T* dg, int n_steps, int B, int H,
                          cudaStream_t s) {
  const RecCfg cfg = rec_cfg<T>(H, kNQ);
  if (cfg.smem > kSmemMax || cfg.hh / 8 > kNE) return cudaErrorInvalidValue;
  auto kernel = wide_rec_cluster_kernel<T, kNQ, kNE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cfg.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3((unsigned)(kCluster * ((B + kRows - 1) / kRows)));
  lc.blockDim = dim3(kThreads);
  lc.dynamicSmemBytes = cfg.smem;
  lc.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  lc.attrs = attr;
  lc.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &lc);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;  // refused
  err = cudaLaunchKernelEx(&lc, kernel, z, cs, dhs, w_ht, dg, n_steps, B, H,
                           cfg);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rec(const float* z, const T* cs, const T* dhs,
                       const T* w_ht, T* dg, int n_steps, int B, int H,
                       cudaStream_t s) {
  if (H <= 32) return launch_rec_at<T, 1, 2>(z, cs, dhs, w_ht, dg, n_steps,
                                             B, H, s);
  if (H <= 64) return launch_rec_at<T, 2, 4>(z, cs, dhs, w_ht, dg, n_steps,
                                             B, H, s);
  if (H <= 96) return launch_rec_at<T, 3, 6>(z, cs, dhs, w_ht, dg, n_steps,
                                             B, H, s);
  return launch_rec_at<T, 2, 8>(z, cs, dhs, w_ht, dg, n_steps, B, H, s);
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

template <typename T>
int launch_bwd(const void* x, const void* w_aug, const void* w_ht,
               const void* w_xt, const void* hs, const void* cs,
               const void* dhs, void* z, void* dg, void* dx, void* partials,
               void* dw, int n_steps, int B, int C, int H, void* stream) {
  if (n_steps < 0 || B < 1 || !fits(C, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  constexpr int kE = 16 / sizeof(T);
  Prod<T> p;
  p.x = static_cast<const T*>(x);
  p.hs = static_cast<const T*>(hs);
  p.w = static_cast<const T*>(w_aug);
  p.wxt = static_cast<const T*>(w_xt);
  p.dg = static_cast<const T*>(dg);
  p.z = static_cast<float*>(z);
  p.dx = static_cast<T*>(dx);
  p.partials = static_cast<float*>(partials);
  p.TB = (long long)n_steps * B;
  p.B = B;
  p.C = C;
  p.H = H;
  p.vec = C % kE == 0 && H % kE == 0 && aligned16(x) && aligned16(hs) &&
          aligned16(w_aug) && aligned16(w_xt) && aligned16(dg);
  const int chunks = dw_chunks(p.TB);
  cudaError_t err = launch_prod<T, kGates>(p, chunks, s);
  if (err != cudaSuccess) return (int)err;
  if (n_steps > 0) {
    err = launch_rec<T>(p.z, static_cast<const T*>(cs),
                        static_cast<const T*>(dhs),
                        static_cast<const T*>(w_ht), static_cast<T*>(dg),
                        n_steps, B, H, s);
    if (err != cudaSuccess) return (int)err;
  }
  err = launch_prod<T, kDx>(p, chunks, s);
  if (err != cudaSuccess) return (int)err;
  err = launch_prod<T, kDw>(p, chunks, s);
  if (err != cudaSuccess) return (int)err;
  // dW = the chunks' partials summed in chunk order
  launch_ordered_sum<0>(p.partials, static_cast<float*>(dw), chunks,
                        (C + H + 1) * 4 * H, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K3 at the wide shapes; returns the cudaError_t of its launches (0 =
// launched). bf16 = 1 takes bf16 tensors, 0 f32 ones. w_ht is W_aug[C:C+H]^T
// (4H, H), w_xt W_aug[:C]^T (4H, C); z (T, B, 4H) f32, dg (T, B, 4H) and
// partials (lstm_wide_bwd_dw_chunks, C+H+1, 4H) f32 are scratch.
int lstm_wide_bwd(int bf16, const void* x, const void* w_aug,
                  const void* w_ht, const void* w_xt, const void* hs,
                  const void* cs, const void* dhs, void* z, void* dg,
                  void* dx, void* partials, void* dw, int n_steps, int B,
                  int C, int H, void* stream) {
  return bf16 ? launch_bwd<bf16_bits>(x, w_aug, w_ht, w_xt, hs, cs, dhs, z,
                                      dg, dx, partials, dw, n_steps, B, C, H,
                                      stream)
              : launch_bwd<float>(x, w_aug, w_ht, w_xt, hs, cs, dhs, z, dg,
                                  dx, partials, dw, n_steps, B, C, H, stream);
}

int lstm_wide_bwd_dw_chunks(int n_steps, int B) {
  return dw_chunks((long long)n_steps * B);
}

const char* lstm_wide_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
