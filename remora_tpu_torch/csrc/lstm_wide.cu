// The LSTM forward legs at the widths the main-shape kernels do not take,
// sm_90a: K1 (last-only forward) and K2 (forward with hs and cs) for every
// 1 <= C <= 128, 1 <= H <= 128, in f32 and bf16. K3, the backward, at those
// widths is lstm_wide_bwd.cu.
//
// Replaces, at those widths, remora_tpu/kernels/pallas_lstm.py::
// _fwd_kernel_last (K1) and _fwd_kernel / _fwd_kernel_nocs (K2), which the
// JAX package runs at any width (_tile_plan shrinks its batch tile for wider
// layers). The main-shape kernels (lstm_fwd_f32.cu, lstm_fwd_mma.cu) keep
// every shape they take; kernels/lstm.py routes only
// the shapes they refuse here (ConvLSTM_w_ref at size 65 .. 128).
//
//   gates_t = [x_t ; h_{t-1}] . W_aug[:C+H] + W_aug[C+H]    (B, 4H), i|f|g|o
//   c_t = sigmoid(f) c_{t-1} + sigmoid(i) tanh(g),  h_t = sigmoid(o) tanh(c_t)
//
// What bounds it (T = 124, B = 2048, C = H = 96; H100 SXM: 67 TFLOP/s FP32,
// 989 bf16, 3.35 TB/s): f32 is operations-bound, 37.5 GFLOP (0.56 ms; 66.6
// GFLOP, 0.99 ms at 128); bf16 moves 146 MB (0.044 ms) and its serial chain,
// T dependent steps, is the floor. W_aug[:C+H] is 295 KB f32 / 147 KB bf16
// at 96 and 524 / 262 KB at 128: more than one block's 227 KB of shared
// memory, so one block cannot hold it, and a design that reads it from L2
// every step (this file's first design) spends its step there.
//
// The design: one cluster of kCluster = 2 CTAs owns kRows = 32 batch rows
// (B = 2048 is 64 clusters on 128 SMs, one wave) and walks all T steps.
// CTA r owns hidden units [r hh, r hh + hh) (hh = ceil(H / 2) rounded up to
// 16), all four gate columns of each, so its gate math needs nothing from
// its partner; it holds its units' slice of W_h (and, in bf16, of W_x) on
// chip for the whole walk. h_{t-1}, all H units, is a double-buffered tile
// in each CTA's shared memory: each CTA writes its units' h_t (the operand:
// rounded to bf16 in bf16) into both CTAs' tiles through distributed shared
// memory, and one cluster barrier a step (barrier.cluster arrive.release /
// wait.acquire) publishes it. x_t . W_x needs no h: it is computed a step
// ahead, between the barrier's arrive and its wait, into the accumulators
// the next step's h_{t-1} . W_h adds to. x arrives by cp.async in a ring of
// slots requested a step or more ahead. Every CTA runs every step and every
// barrier; the launch checks that the card can hold the cluster
// (cudaOccupancyMaxActiveClusters) and is refused otherwise.
//
//   wide_fwd_bf16_kernel: 16 warps; warp w owns the CTA's units 4w ..
//     4w+3 in the layout of lstm_fwd_mma.cu: their 16 gate columns are 2
//     n8 tiles, tile j gates 2j and 2j+1 of the units interleaved, so lane
//     (g, q)'s mma C fragments hold all four gates of unit 4w + q for rows
//     g, g + 8 of each of the two m16 tiles. W_h's B fragments sit in
//     registers (32 at H = 128), loaded once by ldmatrix from a copy in
//     shared memory; W_x's slice stays in shared memory in the same layout
//     ([gate column][k]), both gathered from W_aug at the start. A step, one
//     m16 tile at a time: ldmatrix h_{t-1} from the tile, mma.sync (f32
//     accumulators) on top of x_t . W_x, the gate math in f32, h_t rounded
//     to bf16 into both CTAs' tiles (st.shared::cluster at mapa addresses)
//     and, with c_t, into the CTA's out tiles (three, by step); after the
//     arrive, the out tiles of the step before leave to hs, cs in 8-byte
//     runs, beside the next x product. 16 warps of 4 units (at most 128
//     registers) run the step ~20% faster than 8 warps of 8 (more warps
//     hide the gate math's latency).
//   wide_fwd_f32_kernel: 8 warps in two k groups of 4; in each, thread (row
//     group rg, unit pair p) holds an 8 x 8 FFMA register tile (rows 8 rg
//     .. 8 rg + 7, units 2p, 2p + 1 of its CTA, 4 gates each: (m + n) / mn
//     = 0.25) over its group's half of x's and of h's k, operands read as
//     float4 along k (a quarter-warp shares a row group: its reads
//     broadcast). W_h's slice is in shared memory (128 KB at H = 128, the
//     two units of a pair swizzled so a quarter's reads miss no bank);
//     W_x's is read from the wrapper's layout through L1/L2, a quad of k
//     ahead (kernels/lstm.py::wide_fwd_weights). After the products the
//     groups swap half-tiles through shared memory (one CTA barrier), so
//     each thread finishes 4 rows x 2 units; hs and cs leave from
//     registers, float2 a unit pair. 8 x 8 tiles leave 6 of the 8 warps
//     busy at H = 96 and all 8 at 128.
//
// Numerics are the plain twins' (kernels/lstm.py) and the JAX kernel's: f32
// sums of products of the dtype's values, x's k before h's (f32: each k
// group's half in that order, the two halves then added), the bias added
// after the product, accurate expf and tanhf, the sigmoid's reciprocal
// rounded to nearest (__frcp_rn, the bits of 1.0f / x), c and h carried in
// f32; bf16 rounds h every step (hs is that h) and hs, cs once. Rows past B
// are zero-filled on load and masked on store; units past H and k past C,
// H are zero weights. A repeated call gives the same bits.
//
// On an H100 at 700 W (chip_lstm_fwd_variants.py --compare-parent, --wide):
// K2 with cs at C = H = 96 runs ~14.3 us a step in f32 (the two products
// ~5 us each, the gate math ~2.2) and ~4.2 in bf16 (the gate math ~1.5,
// the products, the exchange and the stores ~0.4-0.7 each).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxC = 128;
constexpr int kMaxH = 128;
constexpr int kCluster = 2;          // CTAs a cluster
constexpr int kRows = 32;            // batch rows a cluster
constexpr size_t kSmemMax = 232448;  // 227 KB a block can use

// bf16: 16 warps of 4 units (their gates two n8 tiles), two m16 row tiles
constexpr int kThreadsBf16 = 512;
constexpr int kUnitsWarp = 4;
constexpr int kXT = kMaxC / 16;  // x k16 tiles at most
constexpr int kHT = kMaxH / 16;  // h k16 tiles at most
constexpr int kStagesBf16 = 4;   // x ring slots
// f32: two k groups of 4 warps of 8 x 8 tiles
constexpr int kThreadsF32 = 256;
constexpr int kTileRows = 8;  // rows a thread
constexpr int kStagesF32 = 2;

static_assert(kThreadsBf16 / 32 * kUnitsWarp == kMaxH / kCluster,
              "bf16: the warps cover a CTA's units at H = kMaxH");
static_assert(kThreadsF32 == 2 * (kRows / kTileRows) * (kMaxH / kCluster / 2),
              "f32: one thread a k group, row group and unit pair at H = "
              "kMaxH");

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// hidden units a CTA owns: half of H, rounded up to a 16-unit block (f32:
// 8 unit pairs, a quarter-warp; bf16: four warps)
__host__ __device__ __forceinline__ int units_per_cta(int H) {
  return round_up((H + kCluster - 1) / kCluster, 16);
}

__device__ __forceinline__ bf16_bits to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf(bf16_bits v) {
  return __uint_as_float((uint32_t)v << 16);
}

// 1 / (1 + e^-z): the reciprocal rounded to nearest is IEEE 1.0f / x's
// result, without the division's slow-path branches
__device__ __forceinline__ float sigmoid(float z) {
  return __frcp_rn(1.0f + expf(-z));
}

// the shared::cluster address of the CTA of rank r's copy of a shared
// variable at shared address a, and a 16-bit store there
__device__ __forceinline__ uint32_t map_rank(uint32_t a, int r) {
  uint32_t v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(v)
               : "r"(a), "r"(r));
  return v;
}
__device__ __forceinline__ void st_cluster(uint32_t a, bf16_bits v) {
  asm volatile("st.shared::cluster.u16 [%0], %1;\n" ::"r"(a), "h"(v)
               : "memory");
}

// the cluster barrier in two halves: arrive (release: this CTA's writes to
// its partner's shared memory are published) and wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ------------------------------- bf16 -------------------------------

// Shared memory: W_x's slice ([4 hh gate columns][ldx], mma B layout), W_h's
// ([4 hh][ldh], the same layout: read once into registers), the h exchange
// tiles (two of [kRows][ldh], all H units), the out tiles (kSeq:
// three of h, and of c where kCs, [kRows][ldo], the CTA's units), the x
// ring (kStagesBf16 of [kRows][ldx]). Row strides are a k16 multiple plus 8
// elements, so ldmatrix's eight 16-byte rows fall in distinct banks.
struct Bf16Cfg {
  int hh, nkx, nkh, ldx, ldh, ldo, n_out;
  size_t wh_off, h_off, o_off, x_off, smem;
};

Bf16Cfg bf16_cfg(int C, int H, bool seq, bool cs) {
  Bf16Cfg c;
  c.hh = units_per_cta(H);
  c.nkx = (C + 15) / 16;
  c.nkh = (H + 15) / 16;
  c.ldx = 16 * c.nkx + 8;
  c.ldh = 16 * c.nkh + 8;
  c.ldo = c.hh + 8;
  c.n_out = seq ? (cs ? 2 : 1) : 0;
  c.wh_off = (size_t)4 * c.hh * c.ldx * 2;  // W_x's rows: x's stride
  c.h_off = c.wh_off + (size_t)4 * c.hh * c.ldh * 2;  // W_h's: h's stride
  c.o_off = c.h_off + (size_t)2 * kRows * c.ldh * 2;
  c.x_off = c.o_off + (size_t)3 * c.n_out * kRows * c.ldo * 2;
  c.smem = c.x_off + (size_t)kStagesBf16 * kRows * c.ldx * 2;
  return c;
}

// kVec: C a multiple of 8 and x 16-byte aligned (16-byte cp.async staging)
template <bool kSeq, bool kCs, bool kVec>
__global__ void __launch_bounds__(kThreadsBf16, 1)
    wide_fwd_bf16_kernel(const bf16_bits* __restrict__ x,
                         const bf16_bits* __restrict__ w_aug,
                         bf16_bits* __restrict__ hs,
                         bf16_bits* __restrict__ cs, int T, int B, int C,
                         int H, Bf16Cfg cfg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  bf16_bits* ws = reinterpret_cast<bf16_bits*>(smem_raw);
  bf16_bits* whs = reinterpret_cast<bf16_bits*>(smem_raw + cfg.wh_off);
  bf16_bits* hb = reinterpret_cast<bf16_bits*>(smem_raw + cfg.h_off);
  bf16_bits* ob = reinterpret_cast<bf16_bits*>(smem_raw + cfg.o_off);
  bf16_bits* xs = reinterpret_cast<bf16_bits*>(smem_raw + cfg.x_off);
  const int hh = cfg.hh, ldx = cfg.ldx, ldh = cfg.ldh, ldo = cfg.ldo;
  const int nkx = cfg.nkx, nkh = cfg.nkh, G = 4 * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int base = rank * hh;
  const int b0 = (blockIdx.x / kCluster) * kRows;
  const bool active = kUnitsWarp * warp < hh;  // warp-uniform
  const int x_tile = kRows * ldx, h_tile = kRows * ldh, o_tile = kRows * ldo;
  const int n_own = max(0, min(hh, H - base));  // the CTA's real units

  // W's slices: row n = 16 (u / 4) + 8 (gate / 2) + 2 (u % 4) + gate % 2
  // for the CTA's unit u (unit group u / 4 is one warp's two n8 tiles),
  // column k < 16 ceil(nk / 16) of W_aug's rows row0 .. row0 + nk - 1; zero
  // past nk and H. Read unit-fastest, so W_aug's rows are read in runs.
  auto gather = [&](bf16_bits* dst, int ld, int row0, int nk) {
    const int k16 = (nk + 15) / 16 * 16;
    for (int e = tid; e < k16 * 4 * hh; e += kThreadsBf16) {
      const int uu = e % hh, rest = e / hh;
      const int gate = rest & 3, k = rest >> 2;
      const int n = 16 * (uu >> 2) + 8 * (gate >> 1) + 2 * (uu & 3) +
                    (gate & 1);
      dst[n * ld + k] =
          (k < nk && base + uu < H)
              ? w_aug[(size_t)(row0 + k) * G + gate * H + base + uu]
              : bf16_bits(0);
    }
  };
  gather(ws, ldx, 0, C);
  gather(whs, ldh, C, H);
  const int k16 = 16 * nkx;
  // both h tiles zero (h_{-1} = 0, units past H stay zero); x's columns C
  // .. 16 nkx of every slot zero
  for (int e = tid; e < 2 * h_tile; e += kThreadsBf16) hb[e] = 0;
  const int pad = k16 - C;
  for (int e = tid; e < kStagesBf16 * kRows * pad; e += kThreadsBf16) {
    const int r = e / pad;
    xs[r * ldx + C + (e - r * pad)] = 0;
  }

  // x_t's kRows rows into slot t % kStagesBf16 (nothing for t >= T)
  auto stage = [&](int t) {
    if (t >= T) return;
    bf16_bits* dst = xs + (t % kStagesBf16) * x_tile;
    const bf16_bits* src = x + ((size_t)t * B + b0) * C;
    if (kVec) {
      const int chunks = C / 8;
      for (int e = tid; e < kRows * chunks; e += kThreadsBf16) {
        const int r = e / chunks, k = (e - r * chunks) * 8;
        const bool ok = b0 + r < B;
        cp_async16z(dst + r * ldx + k, ok ? src + r * C + k : x, ok);
      }
    } else {
      for (int e = tid; e < kRows * C; e += kThreadsBf16) {
        const int r = e / C, k = e - r * C;
        dst[r * ldx + k] = b0 + r < B ? src[e] : bf16_bits(0);
      }
    }
  };
  for (int s = 0; s < kStagesBf16 - 1; ++s) {
    stage(s);
    cp_async_commit();
  }

  // Warp w owns the CTA's units 4w .. 4w + 3: n8 tile j is gates 2j, 2j +
  // 1 of those units interleaved, so lane (g, q)'s C fragments hold all
  // four gates of unit 4w + q. bias[j]: gate j of that unit.
  const int u = base + kUnitsWarp * warp + q;  // the lane's unit in the layer
  const bool u_ok = active && u < H;
  float bias[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bias[j] = u_ok ? bf(w_aug[(size_t)(C + H) * G + j * H + u]) : 0.f;
  }
  // the warp's B fragments of n8 tiles 0 and 1 at k16 tile kt of the slice
  // at w (row stride ld)
  auto b_frags = [&](const bf16_bits* w, int ld, int kt, uint32_t(&b0)[2],
                     uint32_t(&b1)[2]) {
    uint32_t b[4];
    ldsm_x4(b, smem_u32(w + (16 * warp + (lane & 7) + (lane >> 4) * 8) * ld +
                        16 * kt + ((lane >> 3) & 1) * 8));
    b0[0] = b[0];
    b0[1] = b[1];
    b1[0] = b[2];
    b1[1] = b[3];
  };
  uint32_t h_dst[kCluster];  // both CTAs' h tiles (shared::cluster)
#pragma unroll
  for (int r = 0; r < kCluster; ++r) h_dst[r] = map_rank(smem_u32(hb), r);

  // accx[mt][j] += x_t . W_x (m16 tile mt, the warp's n8 tile j)
  auto x_product = [&](int t, float (&accx)[2][2][4]) {
    const bf16_bits* xt = xs + (t % kStagesBf16) * x_tile;
#pragma unroll
    for (int kt = 0; kt < kXT; ++kt) {
      if (kt < nkx) {
        uint32_t b0_[2], b1_[2];
        b_frags(ws, ldx, kt, b0_, b1_);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t a[4];
          ldsm_x4(a, smem_u32(xt + (16 * mt + (lane & 15)) * ldx + 16 * kt +
                              (lane >> 4) * 8));
          mma_16816(accx[mt][0], a, b0_);
          mma_16816(accx[mt][1], a, b1_);
        }
      }
    }
  };

  // the CTA's units of step t's h (and c) from out tile t % 3 into rows
  // row0 .. of hs (and cs): 8-byte chunks of 4 units where H % 4 == 0
  const bool out_vec = H % 4 == 0;
  auto copy_out = [&](int t, long long row0) {
    const bf16_bits* src = ob + (t % 3) * cfg.n_out * o_tile;
    const int per_row = out_vec ? n_own >> 2 : n_own;
    const int n = kRows * per_row;
#pragma unroll 1
    for (int e = tid; e < cfg.n_out * n; e += kThreadsBf16) {
      const int side = e >= n ? 1 : 0;
      const int ee = e - side * n;
      const int r = ee / per_row, k = ee - r * per_row;
      if (b0 + r >= B) continue;
      bf16_bits* dst = (side ? cs : hs) + (row0 + r) * H + base;
      const bf16_bits* sp = src + side * o_tile + r * ldo;
      if (out_vec) {
        *reinterpret_cast<uint2*>(dst + 4 * k) =
            *reinterpret_cast<const uint2*>(sp + 4 * k);
      } else {
        dst[k] = sp[k];
      }
    }
  };

  cp_async_wait<0>();  // x_0 .. x_{kStagesBf16-2} are in
  cluster.sync();  // the partner runs (its tiles exist); W, zeroed tiles

  // W_h's B fragments, held for the whole walk (zero past H)
  uint32_t wh[kHT][2][2];
#pragma unroll
  for (int kt = 0; kt < kHT; ++kt) {
    if (active && kt < nkh) {
      b_frags(whs, ldh, kt, wh[kt][0], wh[kt][1]);
    } else {
      wh[kt][0][0] = wh[kt][0][1] = wh[kt][1][0] = wh[kt][1][1] = 0;
    }
  }

  float accx[2][2][4] = {};  // x_t . W_x of the coming step
  if (active && T > 0) x_product(0, accx);
  float c[2][2] = {};  // c carry (f32), [m16 tile][rows g, g + 8]

  for (int t = 0; t < T; ++t) {
    if (active) {
      const bf16_bits* h_prev = hb + (t & 1) * h_tile;
      const int nb = ((t + 1) & 1) * h_tile;
      bf16_bits* oh = ob + (t % 3) * cfg.n_out * o_tile;
      // one m16 tile at a time: its h product, then its gate math (the
      // next tile's products can run under this one's activations)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float acc[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[j][v] = accx[mt][j][v];
#pragma unroll
        for (int kt = 0; kt < kHT; ++kt) {
          if (kt < nkh) {
            uint32_t a[4];
            ldsm_x4(a, smem_u32(h_prev + (16 * mt + (lane & 15)) * ldh +
                                16 * kt + (lane >> 4) * 8));
            mma_16816(acc[0], a, wh[kt][0]);
            mma_16816(acc[1], a, wh[kt][1]);
          }
        }
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          // C fragment element (j, 2s + p): row g + 8s, gate 2j + p
          const float ig = sigmoid(acc[0][2 * s] + bias[0]);
          const float fg = sigmoid(acc[0][2 * s + 1] + bias[1]);
          const float gg = tanhf(acc[1][2 * s] + bias[2]);
          const float og = sigmoid(acc[1][2 * s + 1] + bias[3]);
          c[mt][s] = fg * c[mt][s] + ig * gg;
          const float cc = c[mt][s];
          const bf16_bits h = to_bf16(og * tanhf(cc));
          if (u_ok) {
            const int row = 16 * mt + g + 8 * s;
#pragma unroll
            for (int r = 0; r < kCluster; ++r) {
              st_cluster(h_dst[r] + 2 * (nb + row * ldh + u), h);
            }
            if (kSeq) {
              const int o = row * ldo + u - base;
              oh[o] = h;
              if (kCs) oh[o_tile + o] = to_bf16(cc);
            }
          }
        }
      }
    }
    cp_async_wait<0>();  // x_{t+2} is in
    cluster_arrive();
    // off the chain, while h_t crosses: x_{t+3} staged into the slot
    // x_{t-1} left, hs_{t-1} (and cs_{t-1}) out, x_{t+1} . W_x
    stage(t + kStagesBf16 - 1);
    cp_async_commit();
    if (kSeq && t > 0) copy_out(t - 1, (long long)(t - 1) * B + b0);
    if (active && t + 1 < T) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) accx[mt][j][v] = 0.f;
      x_product(t + 1, accx);
    }
    cluster_wait();  // h_t of every unit is in this CTA's tile
  }

  if (kSeq) {
    if (T > 0) copy_out(T - 1, (long long)(T - 1) * B + b0);
  } else {  // K1: h_{T-1} from the exchange tile (zeros for T = 0)
    const bf16_bits* hl = hb + (T & 1) * h_tile + base;
    for (int e = tid; e < kRows * n_own; e += kThreadsBf16) {
      const int r = e / n_own, k = e - r * n_own;
      if (b0 + r < B) hs[(size_t)(b0 + r) * H + base + k] = hl[r * ldh + k];
    }
  }
}

// ------------------------------- f32 -------------------------------

// Shared memory: W_h's slice ([hp][4 hh], row k unit-major [unit][gate]),
// the h tiles (two of [kRows][ldh], all H units), the x ring (kStagesF32 of
// [kRows][ldx]), the k groups' partial sums (two of [32][kThreadsF32 / 2]
// floats). cp, hp: C, H rounded up to 4 (the float4 k quads; the wrapper's
// layout pads them with zeros).
struct F32Cfg {
  int hh, cp, hp, ldh, ldx, xvec;
  size_t h_off, x_off, p_off, smem;
};

F32Cfg f32_cfg(int C, int H, const void* x) {
  F32Cfg c;
  c.hh = units_per_cta(H);
  c.cp = round_up(C, 4);
  c.hp = round_up(H, 4);
  c.ldh = c.hp + 4;
  c.ldx = c.cp + 4;
  c.xvec = C % 4 == 0 && aligned16(x);
  c.h_off = (size_t)c.hp * 4 * c.hh * 4;
  c.x_off = c.h_off + (size_t)2 * kRows * c.ldh * 4;
  c.p_off = c.x_off + (size_t)kStagesF32 * kRows * c.ldx * 4;
  c.smem = c.p_off + (size_t)2 * 32 * (kThreadsF32 / 2) * 4;
  return c;
}

template <bool kGlobal>
__device__ __forceinline__ float4 ld4(const float* p) {
  if constexpr (kGlobal) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else {
    return *reinterpret_cast<const float4*>(p);
  }
}

__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[i][j] += sum over quads q0 <= q < q1 of a[i lda + k] . w[k ldw + j]
// (rows i < 8, columns j < 8: the pair's first unit's four gates at w + o0,
// its second's at w + o1), k ascending. kGlobal: W is read through L1/L2,
// the next quad's in flight while a quad sums; else from shared memory,
// with the quad's own loads (fewer registers live).
template <bool kGlobal>
__device__ __forceinline__ void tile_fma(float (&acc)[kTileRows][8],
                                         const float* a, int lda,
                                         const float* w, int ldw, int o0,
                                         int o1, int q0, int q1) {
  auto load_w = [&](int qd, float4(&dst)[4][2]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* row = w + (size_t)(4 * qd + kk) * ldw;
      dst[kk][0] = ld4<kGlobal>(row + o0);
      dst[kk][1] = ld4<kGlobal>(row + o1);
    }
  };
  auto quad = [&](int qd, const float4(&wc)[4][2]) {
    float4 av[kTileRows];
#pragma unroll
    for (int i = 0; i < kTileRows; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + i * lda + 4 * qd);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < kTileRows; ++i) {
        const float ak = part(av[i], kk);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(ak, part(wc[kk][j >> 2], j & 3), acc[i][j]);
      }
  };
  if constexpr (kGlobal) {
    float4 wn[4][2];
    if (q0 < q1) load_w(q0, wn);
    for (int qd = q0; qd < q1; ++qd) {
      float4 wc[4][2];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wc[kk][0] = wn[kk][0];
        wc[kk][1] = wn[kk][1];
      }
      if (qd + 1 < q1) load_w(qd + 1, wn);
      quad(qd, wc);
    }
  } else {
    for (int qd = q0; qd < q1; ++qd) {
      float4 wc[4][2];
      load_w(qd, wc);
      quad(qd, wc);
    }
  }
}

// w_il: the wrapper's layout, (cp + hp, 2 hh, 4): row k < C W_x's, row cp +
// k < H W_h's, [unit][gate] = W_aug[row][gate H + unit], zero elsewhere.
// W_x is read from it through L1/L2, W_h's slice from shared memory.
template <bool kSeq, bool kCs>
__global__ void __launch_bounds__(kThreadsF32, 1)
    wide_fwd_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w_aug,
                        const float* __restrict__ w_il, float* __restrict__ hs,
                        float* __restrict__ cs, int T, int B, int C, int H,
                        F32Cfg cfg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  float* wh_s = reinterpret_cast<float*>(smem_raw);
  float* hb = reinterpret_cast<float*>(smem_raw + cfg.h_off);
  float* xs = reinterpret_cast<float*>(smem_raw + cfg.x_off);
  float* ps = reinterpret_cast<float*>(smem_raw + cfg.p_off);
  const int hh = cfg.hh, ldw = 4 * hh, ldh = cfg.ldh, ldx = cfg.ldx;
  const int cp = cfg.cp, hp = cfg.hp, ld_il = 8 * hh;  // w_il's row
  const int tid = threadIdx.x;
  const int base = rank * hh;
  const int b0 = (blockIdx.x / kCluster) * kRows;
  // k group kg (warps 4 kg .. 4 kg + 3) sums quads [q0, q1) of x's and of
  // h's k; within it thread (row group rg, unit pair p): a quarter-warp is
  // one row group and 8 pairs, a warp 4 row groups of the same 8 pairs.
  // Each thread's tile is rows 8 rg .. 8 rg + 7 of units 2p, 2p + 1; after
  // the products the two groups swap half-tiles, and group kg finishes
  // rows 8 rg + 4 kg .. + 3 (gate math, carries, stores).
  constexpr int kGroup = kThreadsF32 / 2;
  const int kg = tid / kGroup, gt = tid - kg * kGroup;
  const int rg = (gt >> 3) & 3;
  const int p = 8 * (gt >> 5) + (gt & 7);
  const bool active = 2 * p < hh;  // warp-uniform
  const int r0 = kTileRows * rg;
  const int rk = r0 + 4 * kg;  // the rows this thread finishes
  const int u0 = base + 2 * p;  // the pair's first unit in the layer
  const int x_tile = kRows * ldx, h_tile = kRows * ldh;
  const int nqx = cp / 4, nqh = hp / 4;
  const int qx0 = kg ? (nqx + 1) / 2 : 0, qx1 = kg ? nqx : (nqx + 1) / 2;
  const int qh0 = kg ? (nqh + 1) / 2 : 0, qh1 = kg ? nqh : (nqh + 1) / 2;

  // W_h's slice, rows of 4 hh floats: the CTA's units of each w_il row, unit
  // uu's four gates at 4 (uu ^ sw), sw = (uu >> 3) & 1: the pairs of lanes
  // 4 .. 7 of a quarter-warp keep their second unit first, so the
  // quarter's first float4 reads fall in eight distinct bank quads
  for (int e = tid; e < hp * hh; e += kThreadsF32) {
    const int k = e / hh, uu = e - k * hh;
    cp_async16(wh_s + k * ldw + 4 * (uu ^ ((uu >> 3) & 1)),
               w_il + (size_t)(cp + k) * ld_il + 4 * (base + uu));
  }
  cp_async_commit();
  for (int e = tid; e < 2 * h_tile; e += kThreadsF32) hb[e] = 0.f;

  // x_t's kRows rows into slot t % kStagesF32, columns C .. cp and rows
  // past B zero (nothing for t >= T)
  auto stage = [&](int t) {
    if (t >= T) return;
    float* dst = xs + (t % kStagesF32) * x_tile;
    const float* src = x + ((size_t)t * B + b0) * C;
    if (cfg.xvec) {
      const int chunks = C / 4;
      for (int e = tid; e < kRows * chunks; e += kThreadsF32) {
        const int r = e / chunks, k = (e - r * chunks) * 4;
        const bool ok = b0 + r < B;
        cp_async16z(dst + r * ldx + k, ok ? src + r * C + k : x, ok);
      }
    } else {
      for (int e = tid; e < kRows * cp; e += kThreadsF32) {
        const int r = e / cp, k = e - r * cp;
        const bool ok = b0 + r < B && k < C;
        cp_async4(dst + r * ldx + k, ok ? src + r * C + k : x, ok);
      }
    }
  };
  for (int s = 0; s < kStagesF32; ++s) {
    stage(s);
    cp_async_commit();
  }

  float bias[8];  // [unit v of the pair][gate]
#pragma unroll
  for (int v = 0; v < 2; ++v)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      bias[4 * v + g] = active && u0 + v < H
                            ? w_aug[(size_t)(C + H) * 4 * H + g * H + u0 + v]
                            : 0.f;
  float* h_dst[kCluster];
#pragma unroll
  for (int r = 0; r < kCluster; ++r) h_dst[r] = cluster.map_shared_rank(hb, r);
  const int sw = (p >> 2) & 1;  // the swizzle of the pair's two units
  const float* wx = w_il + 4 * u0;
  const float* wh = wh_s + 8 * p;
  // the half-tile this thread gives its partner, and the one it takes
  float* p_out = ps + (1 - kg) * 32 * kGroup + gt;
  const float* p_in = ps + kg * 32 * kGroup + gt;
  const bool pair_vec = H % 2 == 0 && u0 + 1 < H;  // float2 hs / cs stores

  cp_async_wait<0>();  // W_h, x_0 and x_1 are in
  cluster.sync();  // the partner runs (its tiles exist); zeroed tiles

  float accx[kTileRows][8];  // x_t . W_x of the coming step (own quads)
#pragma unroll
  for (int i = 0; i < kTileRows; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) accx[i][j] = 0.f;
  if (active && T > 0) {
    tile_fma<true>(accx, xs + r0 * ldx, ldx, wx, ld_il, 0, 4, qx0, qx1);
  }
  float c[4][2];  // the c carry of the rows this thread finishes
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i][0] = c[i][1] = 0.f;

  for (int t = 0; t < T; ++t) {
    float acc[kTileRows][8];
    if (active) {
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = accx[i][j];
      tile_fma<false>(acc, hb + (t & 1) * h_tile + r0 * ldh, ldh, wh, ldw,
                      4 * sw, 4 - 4 * sw, qh0, qh1);
      // the partner group's rows of the tile, for it to finish
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          p_out[(8 * i + j) * kGroup] = kg ? acc[i][j] : acc[4 + i][j];
    }
    cp_async_wait<0>();  // x_{t+1} is in
    __syncthreads();  // the half-tiles are in; x_t is free
    stage(t + kStagesF32);  // into the slot x_t left
    cp_async_commit();
    if (active) {
      float* nb[kCluster];
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        nb[r] = h_dst[r] + ((t + 1) & 1) * h_tile + rk * ldh + u0;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float h[2];
        float z[8];  // this group's sums, then the partner's
#pragma unroll
        for (int j = 0; j < 8; ++j)
          z[j] = (kg ? acc[4 + i][j] : acc[i][j]) + p_in[(8 * i + j) * kGroup];
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const float ig = sigmoid(z[4 * v] + bias[4 * v]);
          const float fg = sigmoid(z[4 * v + 1] + bias[4 * v + 1]);
          const float gg = tanhf(z[4 * v + 2] + bias[4 * v + 2]);
          const float og = sigmoid(z[4 * v + 3] + bias[4 * v + 3]);
          c[i][v] = fg * c[i][v] + ig * gg;
          h[v] = og * tanhf(c[i][v]);
        }
        // h_t into every CTA's tile: units past H stay zero
#pragma unroll
        for (int r = 0; r < kCluster; ++r) {
          if (u0 + 1 < H) {
            *reinterpret_cast<float2*>(nb[r] + i * ldh) =
                make_float2(h[0], h[1]);
          } else if (u0 < H) {
            nb[r][i * ldh] = h[0];
          }
        }
        const int row = b0 + rk + i;
        if (kSeq && row < B && u0 < H) {
          const size_t o = ((size_t)t * B + row) * H + u0;
          if (pair_vec) {
            *reinterpret_cast<float2*>(hs + o) = make_float2(h[0], h[1]);
            if (kCs) {
              *reinterpret_cast<float2*>(cs + o) =
                  make_float2(c[i][0], c[i][1]);
            }
          } else {
            hs[o] = h[0];
            if (kCs) cs[o] = c[i][0];
            if (u0 + 1 < H) {
              hs[o + 1] = h[1];
              if (kCs) cs[o + 1] = c[i][1];
            }
          }
        }
      }
    }
    cluster_arrive();
    if (active && t + 1 < T) {
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) accx[i][j] = 0.f;
      // off the chain, while h_t crosses
      tile_fma<true>(accx, xs + ((t + 1) % kStagesF32) * x_tile + r0 * ldx,
                     ldx, wx, ld_il, 0, 4, qx0, qx1);
    }
    cluster_wait();  // h_t of every unit is in this CTA's tile
  }

  if (!kSeq) {  // K1: h_{T-1} from the exchange tile (zeros for T = 0)
    const float* hl = hb + (T & 1) * h_tile + base;
    const int n_own = max(0, min(hh, H - base));
    for (int e = tid; e < kRows * n_own; e += kThreadsF32) {
      const int r = e / n_own, k = e - r * n_own;
      if (b0 + r < B) hs[(size_t)(b0 + r) * H + base + k] = hl[r * ldh + k];
    }
  }
}

// ------------------------------- launch -------------------------------

bool fits(int C, int H) {
  return C >= 1 && C <= kMaxC && H >= 1 && H <= kMaxH;
}

// one cluster of kCluster CTAs per kRows rows; refused (never rerouted)
// where the card cannot hold one such cluster
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, int B, int threads, size_t smem,
                           cudaStream_t s, Args... args) {
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3((unsigned)(kCluster * ((B + kRows - 1) / kRows)));
  lc.blockDim = dim3((unsigned)threads);
  lc.dynamicSmemBytes = smem;
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
  err = cudaLaunchKernelEx(&lc, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kSeq, bool kCs>
cudaError_t launch_bf16(const void* x, const void* w_aug, void* hs, void* cs,
                        int T, int B, int C, int H, cudaStream_t s) {
  const Bf16Cfg cfg = bf16_cfg(C, H, kSeq, kCs);
  auto kernel = C % 8 == 0 && aligned16(x)
                    ? wide_fwd_bf16_kernel<kSeq, kCs, true>
                    : wide_fwd_bf16_kernel<kSeq, kCs, false>;
  return launch_cluster(kernel, B, kThreadsBf16, cfg.smem, s,
                        static_cast<const bf16_bits*>(x),
                        static_cast<const bf16_bits*>(w_aug),
                        static_cast<bf16_bits*>(hs),
                        static_cast<bf16_bits*>(cs), T, B, C, H, cfg);
}

template <bool kSeq, bool kCs>
cudaError_t launch_f32(const void* x, const void* w_aug, const void* w_il,
                       void* hs, void* cs, int T, int B, int C, int H,
                       cudaStream_t s) {
  const F32Cfg cfg = f32_cfg(C, H, x);
  if (!aligned16(w_il)) return cudaErrorInvalidValue;
  return launch_cluster(wide_fwd_f32_kernel<kSeq, kCs>, B, kThreadsF32,
                        cfg.smem, s, static_cast<const float*>(x),
                        static_cast<const float*>(w_aug),
                        static_cast<const float*>(w_il),
                        static_cast<float*>(hs), static_cast<float*>(cs), T,
                        B, C, H, cfg);
}

template <bool kSeq, bool kCs>
int launch_fwd(int bf16, const void* x, const void* w_aug, const void* w_il,
               void* hs, void* cs, int T, int B, int C, int H, void* stream) {
  if (T < 0 || B < 1 || !fits(C, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch_bf16<kSeq, kCs>(x, w_aug, hs, cs, T, B, C, H, s)
                    : launch_f32<kSeq, kCs>(x, w_aug, w_il, hs, cs, T, B, C,
                                            H, s));
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 = launched). bf16 = 1 takes
// bf16 tensors, 0 f32 ones. w_aug is W_aug (C + H + 1, 4H); w_il (f32 only,
// null for bf16) the f32 kernel's layout of it, kernels/lstm.py::
// wide_fwd_weights: (round_up(C, 4) + round_up(H, 4), 2
// lstm_wide_fwd_units(H), 4), 16-byte aligned. K2: cs may be null (no cs
// written).
int lstm_wide_fwd(int bf16, const void* x, const void* w_aug,
                  const void* w_il, void* hs, void* cs, int n_steps, int B,
                  int C, int H, void* stream) {
  return cs != nullptr
             ? launch_fwd<true, true>(bf16, x, w_aug, w_il, hs, cs, n_steps,
                                      B, C, H, stream)
             : launch_fwd<true, false>(bf16, x, w_aug, w_il, hs, nullptr,
                                       n_steps, B, C, H, stream);
}

// K1: h_{T-1} (B, H) into out
int lstm_wide_last(int bf16, const void* x, const void* w_aug,
                   const void* w_il, void* out, int n_steps, int B, int C,
                   int H, void* stream) {
  return launch_fwd<false, false>(bf16, x, w_aug, w_il, out, nullptr,
                                  n_steps, B, C, H, stream);
}

// the hidden units each CTA of a cluster owns at H
int lstm_wide_fwd_units(int H) { return units_per_cta(H); }

const char* lstm_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
