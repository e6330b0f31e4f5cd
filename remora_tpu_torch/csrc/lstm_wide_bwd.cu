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
//   wide_prod_f32_kernel, wide_prod_bf16_kernel, (a) and (c): lstm_prod.cuh,
//     shared with lstm_general.cu (K3 above these widths).
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

#include "lstm_prod.cuh"
#include "mma_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxC = 128;
constexpr int kMaxH = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 2;          // CTAs a cluster in (b)
constexpr int kRows = 32;            // batch rows a cluster in (b)
constexpr size_t kSmemMax = 232448;  // 227 KB a block can use

static_assert(kRows == 4 * kWarps, "(b): warp w does rows 4w .. 4w + 3");

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
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

bool fits(int C, int H) {
  return C >= 1 && C <= kMaxC && H >= 1 && H <= kMaxH;
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

template <typename T>
int launch_bwd(const void* x, const void* w_aug, const void* w_ht,
               const void* w_xt, const void* hs, const void* cs,
               const void* dhs, void* z, void* dg, void* dx, void* partials,
               void* dw, int n_steps, int B, int C, int H, void* stream) {
  if (n_steps < 0 || B < 1 || !fits(C, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  constexpr int kE = 16 / sizeof(T);
  prod::Prod<T> p;
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
  p.vec = C % kE == 0 && H % kE == 0 && prod::aligned16(x) &&
          prod::aligned16(hs) && prod::aligned16(w_aug) &&
          prod::aligned16(w_xt) && prod::aligned16(dg);
  const int chunks = prod::dw_chunks(p.TB);
  cudaError_t err = prod::launch_prod<T, prod::kGates>(p, chunks, s);
  if (err != cudaSuccess) return (int)err;
  if (n_steps > 0) {
    err = launch_rec<T>(p.z, static_cast<const T*>(cs),
                        static_cast<const T*>(dhs),
                        static_cast<const T*>(w_ht), static_cast<T*>(dg),
                        n_steps, B, H, s);
    if (err != cudaSuccess) return (int)err;
  }
  err = prod::launch_prod<T, prod::kDx>(p, chunks, s);
  if (err != cudaSuccess) return (int)err;
  err = prod::launch_prod<T, prod::kDw>(p, chunks, s);
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
  return prod::dw_chunks((long long)n_steps * B);
}

const char* lstm_wide_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
