// K2's and K1's bf16 legs on Hopper (sm_90a): the LSTM forward recurrence
// with its gate products on the tensor cores.
//
// Replaces, for bf16, remora_tpu/kernels/pallas_lstm.py::_fwd_kernel /
// _fwd_kernel_nocs (launched by _fwd_call; K2, the training forward that
// writes every hidden state hs and, for the backward, every cell state cs)
// and ::_fwd_kernel_last (launched by _fwd_last_call; K1, the inference
// forward that returns only h_{T-1}). One kernel template serves both:
// kStoreSeq writes hs_t (and cs_t when kCs) every step, and without it
// (K1's last-only form) only h_{T-1} leaves the block. The f32 legs are
// lstm_fwd_f32.cu, one FP32 template of the same two forms.
//
//   gates_t = [x_t ; h_{t-1}] @ W_aug[:C+H] + W_aug[C+H]     (B, 4H), i|f|g|o
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
//   h_t = sigmoid(o) * tanh(c_t)
//
// Only half of the gate product depends on the carry: x_t . W_x needs no h
// and is computed a step ahead; h_{t-1} . W_h (16 x H x 4H a block) is the
// product on the chain. Design:
//   * a block owns 16 batch rows (one m16 tile) and walks all T steps; 16
//     warps, warp w owns hidden units 4w .. 4w+3, whose 16 gate columns are
//     2 n8 tiles: tile j holds gates 2j and 2j+1 of those units, interleaved
//     (column n = unit 4w + n/2, gate 2j + n%2). Lane (g, q)'s mma C
//     fragments then hold rows g, g+8 of unit 4w+q for all four gates, so
//     the gate math needs nothing from another lane (the forward mirror of
//     lstm_bwd_mma.cu's recurrence permutation);
//   * W_aug is staged in shared memory once (16-byte cp.async), and each
//     warp gathers its slices of W_x (C x 16) and W_h (H x 16) into mma B
//     fragments held in registers for the whole walk (32 + 16 registers at
//     C = 128, H = 64), its units' bias in f32 beside them;
//   * step t: ldmatrix h_{t-1}'s A fragments from a double-buffered 16 x H
//     bf16 tile and mma.sync them into accumulators that already hold x_t .
//     W_x, interleaved with x_{t+1}'s k tiles into a second accumulator
//     (no dependence on h); bias, gate math and the c, h carries in f32; h
//     rounded to bf16 into the other tile; one block barrier a step. h_{-1}
//     = 0 is a zeroed tile;
//   * x_t arrives by cp.async (16 bytes where C % 8 == 0 and x is aligned,
//     plain element copies otherwise) in a ring of kStages slots issued
//     kStages - 1 steps ahead, one commit group a step;
//   * hs_{t-1} (and cs_{t-1} from a second double-buffered tile) leave
//     coalesced, 16 bytes a thread where H % 8 == 0, from the shared tiles
//     of the step before; K1 writes only h_{T-1}, from registers.
//
// Numerics are lstm_fwd_reference's and the JAX kernel's: bf16 operands (x
// and the rounded h), f32 sums accumulating x's k tiles and then h's into
// one accumulator (the order of a K = C + H product), the bias added in f32
// after the product, accurate expf and division in the sigmoid and tanhf,
// c and h carried in f32, hs and cs rounded to bf16 once.
//
// Ragged shapes: rows past B are zero-filled on load and masked on store; x
// columns from C to the next k16 edge and units past H are zero, so they
// add nothing. C <= 128 and H <= 64 (the x fragments' and the warps'
// limits); the wrapper refuses anything else.
//
// Bound at the main-path shape (T = 124, B = 2048, C = H = 64; H100 SXM,
// 989 TFLOP/s bf16, 3.35 TB/s): 16.6 GFLOP (0.017 ms); K2 moves x, hs and
// cs, 97.6 MB (0.029 ms), K1 x alone, 32.8 MB. Neither binds: with one
// 16-row block an SM (128 blocks) the serial walk does, about 1.6 us a
// step on an H100 (chip_smoke.py phase 3). Of that, the accurate gate math
// takes about half, most of it the IEEE division of the three sigmoids (its
// slow-path branches split each lane's work into blocks the scheduler
// cannot interleave); the two products, the barrier and the staging the
// rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;          // batch rows a block: one m16 tile
constexpr int kUnits = 4;          // hidden units a warp
constexpr int kMaxH = kUnits * kWarps;
constexpr int kMaxC = 128;
constexpr int kXT = kMaxC / 16;    // x k16 tiles at most
constexpr int kHT = kMaxH / 16;    // h k16 tiles at most
constexpr int kStages = 8;         // x ring slots
constexpr size_t kSmemMax = 232448;  // 227 KB a block can use

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__device__ __forceinline__ bf16_bits to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf(bf16_bits v) {
  return __uint_as_float((uint32_t)v << 16);
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

// Shared memory: the x ring, kStages slots of [kRows][ldx]; the h tiles,
// two of [kRows][ldh]; the c tiles (kCs only), two of [kRows][ldh]; W_aug
// as it lies in global memory, (C + H + 1) x 4H, read once to gather the
// fragments. Row strides of the tiles are a k16 multiple plus 8 elements,
// so ldmatrix's eight 16-byte rows fall in distinct banks.
struct FwdCfg {
  int ldx, ldh;
  size_t h_off, c_off, w_off, smem;
};

FwdCfg fwd_cfg(int C, int H, bool cs) {
  FwdCfg c;
  c.ldx = round_up(C, 16) + 8;
  c.ldh = round_up(H, 16) + 8;
  c.h_off = (size_t)kStages * kRows * c.ldx * 2;
  c.c_off = c.h_off + (size_t)2 * kRows * c.ldh * 2;
  c.w_off = c.c_off + (cs ? (size_t)2 * kRows * c.ldh * 2 : 0);
  c.smem = c.w_off + ((size_t)(C + H + 1) * 4 * H * 2 + 15) / 16 * 16;
  return c;
}

// kVec: C and H multiples of 8 and x, hs, cs 16-byte aligned
template <bool kStoreSeq, bool kCs, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_fwd_mma_kernel(const bf16_bits* __restrict__ x,
                        const bf16_bits* __restrict__ w_aug,
                        bf16_bits* __restrict__ hs, bf16_bits* __restrict__ cs,
                        bf16_bits* __restrict__ h_last, int T, int B, int C,
                        int H, FwdCfg cfg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_bits* xs = reinterpret_cast<bf16_bits*>(smem_raw);
  bf16_bits* hb = reinterpret_cast<bf16_bits*>(smem_raw + cfg.h_off);
  bf16_bits* cb = reinterpret_cast<bf16_bits*>(smem_raw + cfg.c_off);
  bf16_bits* ws = reinterpret_cast<bf16_bits*>(smem_raw + cfg.w_off);
  const int ldx = cfg.ldx, ldh = cfg.ldh, G = 4 * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int nkx = (C + 15) / 16, nkh = (H + 15) / 16;
  const bool active = warp < (H + kUnits - 1) / kUnits;  // has units
  const int u = kUnits * warp + q;  // the lane's unit (C fragments)
  const int b0 = blockIdx.x * kRows;
  const int x_tile = kRows * ldx, h_tile = kRows * ldh;

  // W_aug into shared memory (16-byte cp.async where it is aligned)
  const int n_w = (C + H + 1) * G;
  int w_done = 0;
  if (reinterpret_cast<uintptr_t>(w_aug) % 16 == 0) {
    w_done = n_w / 8 * 8;
    for (int e = tid * 8; e < w_done; e += kThreads * 8) {
      cp_async16(ws + e, w_aug + e);
    }
  }
  for (int e = w_done + tid; e < n_w; e += kThreads) ws[e] = w_aug[e];
  cp_async_commit();

  // x's columns C .. 16 nkx of every slot and both h tiles are zero
  const int pad = 16 * nkx - C;
  for (int e = tid; e < kStages * kRows * pad; e += kThreads) {
    const int r = e / pad;
    xs[r * ldx + C + (e - r * pad)] = 0;
  }
  for (int e = tid; e < 2 * h_tile; e += kThreads) hb[e] = 0;

  // this thread's share of a step's x staging and hs / cs copy-out (the
  // 16-byte forms: at most one chunk each)
  const int x_chunks = C / 8, o_chunks = H / 8;
  const int xr = tid / max(x_chunks, 1), xk = (tid - xr * x_chunks) * 8;
  const bool x_role = kVec && tid < kRows * x_chunks;
  const bool x_ok = b0 + xr < B;
  const int ot = tid >= kThreads / 2 ? tid - kThreads / 2 : tid;
  const bool o_c = tid >= kThreads / 2;  // cs's share (kCs)
  const int orow = ot / max(o_chunks, 1), ok = (ot - orow * o_chunks) * 8;
  const bool o_role = kVec && kStoreSeq && (!o_c || kCs) &&
                      ot < kRows * o_chunks && b0 + orow < B;

  // x_t's 16 rows into slot t % kStages (nothing for t >= T)
  auto stage = [&](int t) {
    if (t >= T) return;
    bf16_bits* dst = xs + (t % kStages) * x_tile;
    const bf16_bits* src = x + ((long long)t * B + b0) * C;
    if (kVec) {
      if (x_role) {
        cp_async16z(dst + xr * ldx + xk, x_ok ? src + xr * C + xk : x, x_ok);
      }
    } else {
      for (int e = tid; e < kRows * C; e += kThreads) {
        const int r = e / C, k = e - r * C;
        dst[r * ldx + k] = b0 + r < B ? src[e] : 0;
      }
    }
  };

  // accx += x_t's k16 tile kt . W_x (this warp's 2 n8 tiles)
  uint32_t wx[kXT][2][2];
  auto x_step = [&](int t, int kt, float (&accx)[2][4]) {
    uint32_t a[4];
    ldsm_x4(a, smem_u32(xs + (t % kStages) * x_tile + (lane & 15) * ldx +
                        16 * kt + (lane >> 4) * 8));
#pragma unroll
    for (int j = 0; j < 2; ++j) mma_16816(accx[j], a, wx[kt][j]);
  };

  // hs_t (and cs_t) from the tiles step t wrote: buffer (t + 1) & 1
  auto copy_out = [&](int t) {
    const int buf = ((t + 1) & 1) * h_tile;
    const long long row0 = (long long)t * B + b0;
    if (kVec) {
      if (o_role) {
        const bf16_bits* s = (o_c ? cb : hb) + buf + orow * ldh + ok;
        bf16_bits* d = (o_c ? cs : hs) + (row0 + orow) * H + ok;
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
      }
    } else {
      const int n = kRows * H;
      for (int e = tid; e < (kCs ? 2 : 1) * n; e += kThreads) {
        const bool c_side = kCs && e >= n;
        const int ee = c_side ? e - n : e;
        const int r = ee / H, k = ee - r * H;
        if (b0 + r < B) {
          (c_side ? cs : hs)[(row0 + r) * H + k] =
              (c_side ? cb : hb)[buf + r * ldh + k];
        }
      }
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    stage(s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 3>();  // W, x_0 and x_1 are in
  __syncthreads();

  // B fragments: n8 tile j of the warp is gates 2j, 2j + 1 of its units
  // interleaved (column n = unit 4 warp + n / 2, gate 2j + n % 2), so lane
  // (g, q)'s C fragments hold all four gates of unit 4 warp + q. wx[kt][j]
  // = W_aug[16 kt + 2q (+1, +8, +9)][that column of lane g], wh the same
  // from row C on; zero past C, H and the warp's units
  uint32_t wh[kHT][2][2];
  float bias[4];
  {
    const int un = kUnits * warp + (g >> 1);
    auto frag = [&](int row, int k, int lim, int col) -> uint32_t {
      if (!active || un >= H) return 0;
      uint32_t v = 0;
      if (k < lim) v = ws[(row + k) * G + col];
      if (k + 1 < lim) v |= (uint32_t)ws[(row + k + 1) * G + col] << 16;
      return v;
    };
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = (2 * j + (g & 1)) * H + un;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int kt = 0; kt < kXT; ++kt) {
          wx[kt][j][hh] = frag(0, 16 * kt + 2 * q + 8 * hh, C, col);
        }
#pragma unroll
        for (int kt = 0; kt < kHT; ++kt) {
          wh[kt][j][hh] = frag(C, 16 * kt + 2 * q + 8 * hh, H, col);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bias[j] = active && u < H ? bf(ws[(C + H) * G + j * H + u]) : 0.f;
    }
  }

  float accx[2][4] = {};  // x_t . W_x of the coming step
  if (active && T > 0) {
#pragma unroll
    for (int kt = 0; kt < kXT; ++kt) {
      if (kt < nkx) x_step(0, kt, accx);
    }
  }
  float c[2] = {0.f, 0.f};           // c carry (f32), rows g, g + 8
  bf16_bits h_out[2] = {0, 0};       // h_t rounded, rows g, g + 8

  for (int t = 0; t < T; ++t) {
    const bf16_bits* h_prev = hb + (t & 1) * h_tile;
    float acc[2][4];
    if (active) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[j][v] = accx[j][v];
          accx[j][v] = 0.f;
        }
      // h_{t-1}'s k tiles into acc and x_{t+1}'s (no dependence on h) into
      // accx, side by side
      const bool more = t + 1 < T;
#pragma unroll
      for (int kt = 0; kt < kXT; ++kt) {
        if (kt < kHT && kt < nkh) {
          uint32_t a[4];
          ldsm_x4(a, smem_u32(h_prev + (lane & 15) * ldh + 16 * kt +
                              (lane >> 4) * 8));
#pragma unroll
          for (int j = 0; j < 2; ++j) mma_16816(acc[j], a, wh[kt % kHT][j]);
        }
        if (more && kt < nkx) x_step(t + 1, kt, accx);
      }
    }
    if (kStoreSeq && t > 0) copy_out(t - 1);
    stage(t + kStages - 1);  // the slot x_{t-1} left
    cp_async_commit();

    if (active) {
      const int nb = ((t + 1) & 1) * h_tile;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        // C fragment element (j, 2s + p): row g + 8s, gate 2j + p
        const float ig = sigmoid(acc[0][2 * s] + bias[0]);
        const float fg = sigmoid(acc[0][2 * s + 1] + bias[1]);
        const float gg = tanhf(acc[1][2 * s] + bias[2]);
        const float og = sigmoid(acc[1][2 * s + 1] + bias[3]);
        c[s] = fg * c[s] + ig * gg;
        h_out[s] = to_bf16(u < H ? og * tanhf(c[s]) : 0.f);
        const int off = nb + (g + 8 * s) * ldh + u;
        hb[off] = h_out[s];
        if (kCs) cb[off] = to_bf16(c[s]);
      }
    }
    cp_async_wait<kStages - 3>();  // x_{t+2} is in
    __syncthreads();
  }

  if (kStoreSeq) {
    if (T > 0) copy_out(T - 1);
  } else if (active && u < H) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int row = b0 + g + 8 * s;
      if (row < B) h_last[(long long)row * H + u] = h_out[s];
    }
  }
}

bool fits(int C, int H) {
  return C >= 1 && H >= 1 && C <= kMaxC && H <= kMaxH;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kStoreSeq, bool kCs>
int launch(const void* x, const void* w_aug, void* hs, void* cs, void* h_last,
           int T, int B, int C, int H, void* stream) {
  const FwdCfg cfg = fwd_cfg(C, H, kCs);
  const bool vec = C % 8 == 0 && H % 8 == 0 && aligned16(x) &&
                   (!kStoreSeq || aligned16(hs)) && (!kCs || aligned16(cs));
  auto kernel = vec ? lstm_fwd_mma_kernel<kStoreSeq, kCs, true>
                    : lstm_fwd_mma_kernel<kStoreSeq, kCs, false>;
  if (cfg.smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cfg.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(B + kRows - 1) / kRows, kThreads, cfg.smem,
           (cudaStream_t)stream>>>(
      static_cast<const bf16_bits*>(x), static_cast<const bf16_bits*>(w_aug),
      static_cast<bf16_bits*>(hs), static_cast<bf16_bits*>(cs),
      static_cast<bf16_bits*>(h_last), T, B, C, H, cfg);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launcher returns the cudaError_t of its launch (0 = launched).
// Tensors are contiguous bf16: x (T, B, C), w_aug (C + H + 1, 4H).

// K2: hs (T, B, H) and, unless cs is null, cs (T, B, H)
int lstm_fwd_mma(const void* x, const void* w_aug, void* hs, void* cs, int T,
                 int B, int C, int H, void* stream) {
  if (T < 0 || B < 1 || !fits(C, H)) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  return cs != nullptr
             ? launch<true, true>(x, w_aug, hs, cs, nullptr, T, B, C, H,
                                  stream)
             : launch<true, false>(x, w_aug, hs, nullptr, nullptr, T, B, C,
                                   H, stream);
}

// K1: h_{T-1} (B, H) only (zeros for T = 0)
int lstm_fwd_mma_last(const void* x, const void* w_aug, void* out, int T,
                      int B, int C, int H, void* stream) {
  if (T < 0 || B < 1 || !fits(C, H)) return (int)cudaErrorInvalidValue;
  return launch<false, false>(x, w_aug, nullptr, nullptr, out, T, B, C, H,
                              stream);
}

int lstm_fwd_mma_max_c(void) { return kMaxC; }
int lstm_fwd_mma_max_h(void) { return kMaxH; }

const char* lstm_fwd_mma_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
