// Banded refinement DP on Hopper (sm_90a): the forward pass (K4) and the
// traceback walk (K5).
//
// Replaces the TPU kernels remora_tpu/kernels/pallas_dp.py::_forward_kernel
// and ::_traceback_kernel (both launched by _dp_jit). For each read r of a
// launch, over its bases n = 0 .. N-1, with band start st = starts[r, n],
// band width w = widths[r, n] (<= W) and expected level lv = levels[r, n]:
//
//   base[p] = (signal[r, st + p] - lv)^2                       p < w
//   Viterbi:  score[p] = min(move[p], score[p-1] + base[p])    (move wins
//             only when strictly smaller; tb = 0 on a move, tb[p-1] + 1 on
//             a stay), move[p] = prev[p - 1 + bsd] + base[p], bsd = st -
//             previous start;
//   dwell_penalty: the Viterbi pass gives the unpenalized scores; each row
//             then takes the best of the short-dwell candidates (dwell d <
//             L, penalty sdp[d]) and the unpenalized long-dwell one, and
//             rows past the previous band by L or more are a stay-only
//             chain.
//
// K4 writes one int16 traceback row per base, tb[r, n, 0 .. W-1] (rows p >=
// w hold 0); K5 walks them back from the read's signal end and writes the
// int32 path[r, 0 .. N] (path[0] = 0, path[i] = the signal end for i >=
// seq_len).
//
// Design (a simple kernel that is right; see PERF.md for its times):
//   * K4: one thread block per read. Band rows go across the block's
//     threads for the data-parallel parts (band costs, move candidates, the
//     dwell candidates); one thread runs each stay fold over the base's own
//     w rows, in order (the TPU kernel's _stay_fold, bounded per base as
//     its n_groups bounds it per lane tile). dwell_penalty's second fold
//     takes the candidate unconditionally below row p0c, so the block copies
//     those rows and one thread folds only the past-band suffix, rows p0c
//     .. w-1, as a running sum. The per-base state lives in
//     dynamic shared memory: prev scores, band costs, candidates and tb
//     codes, plus the unpenalized scores and codes in dwell mode (at most
//     six 4-byte arrays of W: 96 KB at W = 4096). The signal is read
//     straight from global memory at each band's offset: none of the TPU
//     kernel's signal staging windows, sublane shifts, 128-lane padding or
//     traceback DMA staging exists here. Each base's tb row is stored from
//     shared memory by all threads, coalesced.
//   * K5: one thread per read, one int16 load per base.
//   * Numerics: every sum and product is an explicit __fadd_rn / __fmul_rn
//     (never contracted into an FMA; the build also passes --fmad=false),
//     in the association of the native C++ DP and the Pallas kernels: the
//     dwell run sums add the lower index last, candidates compare with a
//     strict <, the fold carry starts at +inf, and the sentinels are the
//     Pallas kernel's (BIG = 3.0e38, LARGE_SCORE = 100). Paths are
//     bit-identical to theirs.
//
// Bound: no roofline applies. K4's floor is its serial chain: the folded
// rows of every base x the dependent latency of one fold step (an f32 add,
// a compare and a select), plus in dwell mode the past-band suffix rows x
// the latency of one f32 add. K5 moves N x 2 bytes a read. chip_smoke.py
// phase 8 states both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr float kLargeScore = 100.0f;
constexpr int kThreads = 128;
constexpr int kMaxBand = 4096;  // = REFINE_DEVICE_MAX_BAND
constexpr int kMaxDwell = 32;

// One row of the exact sequential stay fold (the TPU kernel's _stay_fold):
// stay = carry + base; the candidate is taken on strict improvement.
__device__ __forceinline__ void fold_row(float& cs, int& ct, float b, float c,
                                         int t, int i, int w, float* out_s,
                                         int* out_t) {
  if (i >= w) return;
  const float stay = __fadd_rn(cs, b);
  const bool take = c < stay;
  cs = take ? c : stay;
  ct = take ? t : ct + 1;
  out_s[i] = cs;
  out_t[i] = ct;
}

// The fold over rows 0 .. w-1, four rows a step: the operands of the next
// four rows are loaded (16-byte shared loads) before this step's chain
// runs, so the shared-load latency stays off the serial chain. The fold
// reads each row before it writes it and writes each row once, so out_t
// may be ctb itself. Rows w .. W-1 of the inputs may be read, never used.
__device__ __forceinline__ void stay_fold(const float* base, const float* cand,
                                          const int* ctb, float* out_s,
                                          int* out_t, int w) {
  float cs = __int_as_float(0x7f800000);  // +inf
  int ct = 0;
  float4 b = *reinterpret_cast<const float4*>(base);
  float4 c = *reinterpret_cast<const float4*>(cand);
  int4 t = *reinterpret_cast<const int4*>(ctb);
  for (int g = 0; g < w; g += 4) {
    const int gn = g + 4 < w ? g + 4 : g;
    const float4 bn = *reinterpret_cast<const float4*>(base + gn);
    const float4 cn = *reinterpret_cast<const float4*>(cand + gn);
    const int4 tn = *reinterpret_cast<const int4*>(ctb + gn);
    fold_row(cs, ct, b.x, c.x, t.x, g, w, out_s, out_t);
    fold_row(cs, ct, b.y, c.y, t.y, g + 1, w, out_s, out_t);
    fold_row(cs, ct, b.z, c.z, t.z, g + 2, w, out_s, out_t);
    fold_row(cs, ct, b.w, c.w, t.w, g + 3, w, out_s, out_t);
    b = bn;
    c = cn;
    t = tn;
  }
}

// dwell_penalty's second fold over rows lo .. w-1 (1 <= lo < w). Rows
// below lo take their candidate whatever the carry, so the fold from row 0
// reaches row lo - 1 holding (cand[lo-1], ctb[lo-1]); every row from lo on
// is a stay. The chain is a running sum, one add a row.
__device__ __forceinline__ void stay_suffix(const float* base,
                                            const float* cand, int* ctb,
                                            float* out_s, int lo, int w) {
  float cs = cand[lo - 1];
  int ct = ctb[lo - 1];
#pragma unroll 4
  for (int i = lo; i < w; ++i) {
    cs = __fadd_rn(cs, base[i]);
    out_s[i] = cs;
    ctb[i] = ++ct;
  }
}

template <bool kDwell>
__global__ void __launch_bounds__(kThreads)
    dp_forward_kernel(const float* __restrict__ signal,
                      const float* __restrict__ levels,
                      const int* __restrict__ starts,
                      const int* __restrict__ widths,
                      const float* __restrict__ sdp_g, int L, int R, int N,
                      int S, int W, int16_t* __restrict__ tb) {
  extern __shared__ float smem[];
  float* prev = smem;                               // W: carried scores
  float* base = prev + W;                           // W: band costs
  float* cand = base + W;                           // W: fold candidates
  int* ctb = reinterpret_cast<int*>(cand + W);      // W: tb codes
  float* unpen = reinterpret_cast<float*>(ctb + W);  // W (dwell)
  int* unpen_tb = reinterpret_cast<int*>(unpen + W);  // W (dwell)
  __shared__ float sdp[kMaxDwell];

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const float* sig = signal + static_cast<int64_t>(r) * S;
  const float* lvl = levels + static_cast<int64_t>(r) * N;
  const int* st_r = starts + static_cast<int64_t>(r) * N;
  const int* wd_r = widths + static_cast<int64_t>(r) * N;
  int16_t* tb_r = tb + static_cast<int64_t>(r) * N * W;

  if (kDwell && tid < L) sdp[tid] = sdp_g[tid];
  for (int p = tid; p < W; p += kThreads) prev[p] = p == 0 ? 0.0f : kBig;
  // spoofed carry for the first base: bsd = 1, width w[0]
  int prev_start = st_r[0] - 1;
  int prev_valid = min(max(wd_r[0], 1), W);
  __syncthreads();

  for (int n = 0; n < N; ++n) {
    const int st = st_r[n];
    // the wrapper checks 1 <= w <= W; the clamp only keeps a bad input
    // inside shared memory
    const int w = min(max(wd_r[n], 1), W);
    const float level = lvl[n];
    const int bsd = st - prev_start;
    const float prev_last = prev[prev_valid - 1];
    const bool entry_bsd0 = bsd == 0;
    const int move_limit = min(prev_valid - bsd, w - 1);

    // band costs and move candidates (_move_entries)
    for (int p = tid; p < w; p += kThreads) {
      const int col = st + p;
      const float s = (col >= 0 && col < S) ? sig[col] : 0.0f;
      const float d = __fsub_rn(s, level);
      const float b = __fmul_rn(d, d);
      base[p] = b;
      const int src = p - 1 + bsd;
      float mv = (src >= 0 && src < prev_valid) ? __fadd_rn(prev[src], b)
                                                 : kBig;
      const bool at_entry = p == 0 && entry_bsd0;
      if (at_entry) mv = __fadd_rn(kLargeScore, prev_last);
      if (!(p <= move_limit || p == 0)) mv = kBig;
      cand[p] = mv;
      ctb[p] = at_entry ? -1 : 0;
    }
    __syncthreads();

    if (!kDwell) {
      if (tid == 0) stay_fold(base, cand, ctb, prev, ctb, w);
    } else {
      // the unpenalized Viterbi pass, kept for the long-dwell candidate
      if (tid == 0) stay_fold(base, cand, ctb, unpen, unpen_tb, w);
      __syncthreads();
      // short- and long-dwell candidates (_dwell_candidates)
      const int p0 = prev_valid - bsd + L;
      const float invalid = __fadd_rn(kLargeScore, prev_last);
      for (int p = tid; p < w; p += kThreads) {
        float curr = invalid;
        int t = -1;
        const bool in_main = p < p0;
        const bool entry_blocked = p == 0 && entry_bsd0;
        float run = base[p];
        for (int d = 0; d < L; ++d) {
          if (d > 0 && p - d >= 0) run = __fadd_rn(run, base[p - d]);
          const int prev_idx = p - d - 1 + bsd;
          const bool valid = in_main && p >= d && !(entry_bsd0 && p == d) &&
                             !entry_blocked && prev_idx >= 0 &&
                             prev_idx < prev_valid;
          if (valid) {
            const float c = __fadd_rn(__fadd_rn(prev[prev_idx], run), sdp[d]);
            if (c < curr) {
              curr = c;
              t = d;
            }
          }
        }
        if (in_main && p >= L) {
          const float c = __fadd_rn(unpen[p - L], run);
          if (c < curr) {
            curr = c;
            t = unpen_tb[p - L] + L;
          }
        }
        cand[p] = curr;
        ctb[p] = t;
      }
      __syncthreads();
      // the second fold: rows below p0c take their candidate (a copy across
      // the block), the past-band rows from p0c on are a stay-only suffix
      const int p0c = max(p0, 1);
      for (int p = tid; p < min(p0c, w); p += kThreads) prev[p] = cand[p];
      if (tid == 0 && p0c < w) stay_suffix(base, cand, ctb, prev, p0c, w);
    }
    __syncthreads();

    // the base's traceback row, coalesced across the block
    int16_t* row = tb_r + static_cast<int64_t>(n) * W;
    for (int p = tid; p < W; p += kThreads)
      row[p] = p < w ? static_cast<int16_t>(ctb[p]) : int16_t(0);
    prev_start = st;
    prev_valid = w;
    // rows p < w of ctb are rewritten next base by the thread that just
    // stored them, and prev is not written before the next barrier
  }
}

__global__ void dp_traceback_kernel(const int16_t* __restrict__ tb,
                                    const int* __restrict__ starts,
                                    const int* __restrict__ widths,
                                    const int* __restrict__ seq_lens, int R,
                                    int N, int W, int* __restrict__ path) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int* st_r = starts + static_cast<int64_t>(r) * N;
  const int* wd_r = widths + static_cast<int64_t>(r) * N;
  const int16_t* tb_r = tb + static_cast<int64_t>(r) * N * W;
  int* path_r = path + static_cast<int64_t>(r) * (N + 1);
  const int sl = min(max(seq_lens[r], 1), N);
  const int sig_end = st_r[sl - 1] + wd_r[sl - 1];
  for (int i = sl; i <= N; ++i) path_r[i] = sig_end;
  int nxt = sig_end;
  for (int i = sl - 1; i >= 1; --i) {
    const int lookup = nxt - 1;
    const int off = min(max(lookup - st_r[i], 0), W - 1);
    nxt = lookup - static_cast<int>(tb_r[static_cast<int64_t>(i) * W + off]);
    path_r[i] = nxt;
  }
  path_r[0] = 0;
}

}  // namespace

extern "C" {

int banded_dp_max_dwell() { return kMaxDwell; }

const char* banded_dp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K4. signal (R, S) f32, levels / starts / widths (R, N), sdp (L,) f32 ->
// tb (R, N, W) int16. Returns a cudaError_t (0 on a clean launch).
int banded_dp_forward(const float* signal, const float* levels,
                      const int* starts, const int* widths, const float* sdp,
                      int L, int dwell, int R, int N, int S, int W,
                      int16_t* tb, void* stream) {
  if (R <= 0 || N <= 0) return 0;
  if (W <= 0 || W > kMaxBand || L < 0 || L > kMaxDwell)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(W) * 4 * (dwell ? 6 : 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dwell) {
    err = cudaFuncSetAttribute(dp_forward_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dp_forward_kernel<true><<<R, kThreads, smem, s>>>(
        signal, levels, starts, widths, sdp, L, R, N, S, W, tb);
  } else {
    err = cudaFuncSetAttribute(dp_forward_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dp_forward_kernel<false><<<R, kThreads, smem, s>>>(
        signal, levels, starts, widths, sdp, L, R, N, S, W, tb);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5. tb (R, N, W) int16, starts / widths (R, N), seq_lens (R,) -> path
// (R, N + 1) int32.
int banded_dp_traceback(const int16_t* tb, const int* starts,
                        const int* widths, const int* seq_lens, int R, int N,
                        int W, int* path, void* stream) {
  if (R <= 0) return 0;
  constexpr int kTbThreads = 64;
  dp_traceback_kernel<<<(R + kTbThreads - 1) / kTbThreads, kTbThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      tb, starts, widths, seq_lens, R, N, W, path);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
