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
//   * K5: one thread block per read; a producer warp streams the read's
//     traceback rows into a ring in shared memory by TMA bulk copies, in
//     descending base order, ahead of one walker thread, so the walk's
//     serial chain holds no device-memory load (see the K5 section).
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
// the latency of one f32 add. K5's floor is its walk: the longest read's
// walked bases x one dependent shared-memory load and one add. K5 needs
// N x 2 bytes of tb a read, but streams whole rows. chip_smoke.py phase 8
// states both floors.

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

// ---------------- K4 for bands of W <= kStagedMaxBand ----------------
//
// The block path above keeps every base's work between block barriers and
// reads the base's metadata and signal from device memory at the top of
// the base, on the chain between one fold and the next; and its fold runs
// ~44 cycles a row against the 12 of its dependent ops (chip_dp_variants.py
// splits it: 2.87 us a base at W = 128 on an H100, 1.83 of them the
// folds). The staged path splits the block into two roles:
//   * producers (3 warps): for a chunk of bases, one chunk ahead of the
//     consumers, the band's start and width, its costs base[p] =
//     (signal[st + p] - level)^2 (kBatch signal loads in flight a thread)
//     and, in
//     dwell_penalty mode, the dwell run sums run_d[p] = base[p] + base[p-1]
//     + ... + base[p-d] (the block path's order), into a double-buffered
//     ring in shared memory. One block barrier a chunk hands a buffer over;
//     no device-memory load is on the consumers' chain.
//   * consumers: a fold warp, whose thread 0 runs the folds, and 4 row
//     warps, whose thread p owns band row p (W <= 128) for the parallel
//     phases (the move candidates, the dwell candidates with the copy of
//     the rows below p0c, the traceback row's store, coalesced); the
//     consumers' own named barrier between phases. The short-dwell
//     candidates need only the previous base's scores, so the row warps
//     take them while the fold warp runs the first fold (in a warp of
//     their own, the rows do not serialize with the fold). The
//     carried scores are double-buffered by base, so the dwell candidates
//     read the previous base's scores while the copy writes the new ones.
//   * the fold (fold_rows) runs four rows a group with no per-row branch
//     (rows w .. up to the next multiple of 8 fold on stale inputs and are
//     never read), a group's scores and codes stored as one 16-byte store
//     each, two groups' operands in flight; the carried score takes
//     fminf(cand, stay), so the score chain is FADD -> FMNMX, and the
//     code's select runs beside it. fminf is the strict-< select's value
//     unless stay is NaN (no score is -0), and stay is NaN exactly from
//     the base's first NaN band cost on (a NaN signal sample or level):
//     the producers note that row (nan_row), and the move phase makes the
//     candidates of the rows from it on NaN, where fminf gives NaN as the
//     select does (the codes are unchanged: c < NaN is false either way).
//     So tb stays the block path's and the plain twin's on any input.
// The folds stay one serial pass in row order with the block path's
// association: tb rows and paths are bit-identical to it.

constexpr int kFoldThreads = 32;        // the fold's warp: thread 0 folds
constexpr int kStagedMaxBand = 128;     // rows: one row thread each
constexpr int kConsumerThreads = kFoldThreads + kStagedMaxBand;
constexpr int kProducerThreads = 96;
constexpr int kStagedThreads = kConsumerThreads + kProducerThreads;
constexpr int kBatch = 8;              // a producer's signal loads in flight
constexpr int kMaxChunk = 16;          // bases a ring buffer
constexpr int kRingBudget = 160 * 1024;  // bytes of the two ring buffers

// named barriers of one role's warps (barrier 0 is __syncthreads)
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kProducerThreads) : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

__host__ __device__ __forceinline__ int round4(int v) {
  return (v + 3) & ~3;
}

// Rows g .. g+3 of the stay fold; see the note above. The group's scores
// and codes leave as one 16-byte store each.
__device__ __forceinline__ void fold_group(float& cs, int& ct, float4 b,
                                           float4 c, int4 t, float* os,
                                           int* ot) {
  float4 so;
  int4 to;
  float stay = __fadd_rn(cs, b.x);
  ct = c.x < stay ? t.x : ct + 1;
  cs = fminf(c.x, stay);
  so.x = cs;
  to.x = ct;
  stay = __fadd_rn(cs, b.y);
  ct = c.y < stay ? t.y : ct + 1;
  cs = fminf(c.y, stay);
  so.y = cs;
  to.y = ct;
  stay = __fadd_rn(cs, b.z);
  ct = c.z < stay ? t.z : ct + 1;
  cs = fminf(c.z, stay);
  so.z = cs;
  to.z = ct;
  stay = __fadd_rn(cs, b.w);
  ct = c.w < stay ? t.w : ct + 1;
  cs = fminf(c.w, stay);
  so.w = cs;
  to.w = ct;
  *reinterpret_cast<float4*>(os) = so;
  *reinterpret_cast<int4*>(ot) = to;
}

__device__ __forceinline__ void fold_rows(const float* base, const float* cand,
                                          const int* ctb, float* out_s,
                                          int* out_t, int w) {
  float cs = __int_as_float(0x7f800000);  // +inf
  int ct = 0;
  // two groups' operands in flight, each set reloaded right after its rows
  // fold. Rows up to the next multiple of 8 fold (W is one), on stale
  // inputs past w.
  const int g1 = 4 < w ? 4 : 0;
  float4 ba = *reinterpret_cast<const float4*>(base);
  float4 ca = *reinterpret_cast<const float4*>(cand);
  int4 ta = *reinterpret_cast<const int4*>(ctb);
  float4 bb = *reinterpret_cast<const float4*>(base + g1);
  float4 cb = *reinterpret_cast<const float4*>(cand + g1);
  int4 tb = *reinterpret_cast<const int4*>(ctb + g1);
  for (int g = 0; g < w; g += 8) {
    fold_group(cs, ct, ba, ca, ta, out_s + g, out_t + g);
    const int ga = g + 8 < w ? g + 8 : 0;
    ba = *reinterpret_cast<const float4*>(base + ga);
    ca = *reinterpret_cast<const float4*>(cand + ga);
    ta = *reinterpret_cast<const int4*>(ctb + ga);
    fold_group(cs, ct, bb, cb, tb, out_s + g + 4, out_t + g + 4);
    const int gb = g + 12 < w ? g + 12 : 0;
    bb = *reinterpret_cast<const float4*>(base + gb);
    cb = *reinterpret_cast<const float4*>(cand + gb);
    tb = *reinterpret_cast<const int4*>(ctb + gb);
  }
}

__device__ __forceinline__ float band_cost(const float* sig, int S, int col,
                                           float level) {
  const float s = (col >= 0 && col < S) ? sig[col] : 0.0f;
  const float d = __fsub_rn(s, level);
  return __fmul_rn(d, d);
}

// The ring: two buffers of `chunk` bases, each [st][w][nan_row] (ints,
// padded to 4; nan_row is the base's first row with a NaN band cost, or
// W) then run[base][d][Wp] (d < n_run; run[.][0] is the band cost).
struct Ring {
  int chunk, n_run, Wp, buf_words;
  __device__ int* st(float* ring, int b) const {
    return reinterpret_cast<int*>(ring + b * buf_words);
  }
  __device__ int* wd(float* ring, int b) const {
    return st(ring, b) + round4(chunk);
  }
  __device__ int* nan_row(float* ring, int b) const {
    return st(ring, b) + 2 * round4(chunk);
  }
  __device__ float* run(float* ring, int b, int k, int d) const {
    return ring + b * buf_words + 3 * round4(chunk) +
           (k * n_run + d) * Wp;
  }
};

__host__ __device__ __forceinline__ int ring_buf_words(int chunk, int n_run,
                                                       int Wp) {
  return 3 * round4(chunk) + chunk * n_run * Wp;
}

template <bool kDwell>
__global__ void __launch_bounds__(kStagedThreads)
    dp_forward_staged_kernel(const float* __restrict__ signal,
                           const float* __restrict__ levels,
                           const int* __restrict__ starts,
                           const int* __restrict__ widths,
                           const float* __restrict__ sdp_g, int L, int N,
                           int S, int W, int chunk,
                           int16_t* __restrict__ tb) {
  extern __shared__ __align__(16) float smem_s[];
  const int Wp = round4(W);
  float* prev_buf = smem_s;                        // 2 x Wp: carried scores
  float* cand = prev_buf + 2 * Wp;                 // Wp
  int* ctb = reinterpret_cast<int*>(cand + Wp);    // Wp
  float* unpen = reinterpret_cast<float*>(ctb + Wp);  // Wp (dwell)
  int* unpen_tb = reinterpret_cast<int*>(unpen + Wp);  // Wp (dwell)
  float* ring = reinterpret_cast<float*>(unpen_tb + Wp);
  __shared__ float sdp[kMaxDwell];
  __shared__ float plv[kMaxChunk];  // the producers' chunk levels
  const Ring rg{chunk, kDwell ? max(L, 1) : 1, Wp,
                ring_buf_words(chunk, kDwell ? max(L, 1) : 1, Wp)};

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const bool consumer = tid < kConsumerThreads;
  const float* sig = signal + static_cast<int64_t>(r) * S;
  const float* lvl = levels + static_cast<int64_t>(r) * N;
  const int* st_r = starts + static_cast<int64_t>(r) * N;
  const int* wd_r = widths + static_cast<int64_t>(r) * N;
  int16_t* tb_r = tb + static_cast<int64_t>(r) * N * W;
  const int n_chunks = (N + chunk - 1) / chunk;

  // the producer warps stage chunk c into buffer c & 1: the bases' starts,
  // widths and levels, then their band costs (kBatch signal loads in
  // flight a thread), then in dwell_penalty mode the run sums from the
  // staged costs; a named barrier of the producers between the phases
  auto produce = [&](int c) {
    const int b = c & 1;
    const int n0 = c * chunk;
    const int cnt = min(chunk, N - n0);
    const int ptid = tid - kConsumerThreads;
    int* mst = rg.st(ring, b);
    int* mwd = rg.wd(ring, b);
    int* mnan = rg.nan_row(ring, b);
    if (ptid < cnt) {
      mst[ptid] = st_r[n0 + ptid];
      mwd[ptid] = min(max(wd_r[n0 + ptid], 1), W);
      mnan[ptid] = W;
      plv[ptid] = lvl[n0 + ptid];
    }
    producers_sync();
    const int n_el = cnt * W;
    for (int e0 = ptid; e0 < n_el; e0 += kProducerThreads * kBatch) {
      float sv[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int e = e0 + i * kProducerThreads;
        const int k = e / W, p = e - k * W;
        const int col = e < n_el ? mst[k] + p : -1;
        sv[i] = (e < n_el && p < mwd[k] && col >= 0 && col < S) ? sig[col]
                                                                : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int e = e0 + i * kProducerThreads;
        const int k = e / W, p = e - k * W;
        if (e < n_el && p < mwd[k]) {
          const float d = __fsub_rn(sv[i], plv[k]);
          const float cost = __fmul_rn(d, d);
          rg.run(ring, b, k, 0)[p] = cost;
          if (isnan(cost)) atomicMin(&mnan[k], p);
        }
      }
    }
    if (rg.n_run > 1) {
      producers_sync();
      for (int e = ptid; e < n_el; e += kProducerThreads) {
        const int k = e / W, p = e - k * W;
        if (p >= mwd[k]) continue;
        const float* cost = rg.run(ring, b, k, 0);
        float run = cost[p];
        for (int d = 1; d < rg.n_run; ++d) {
          if (p - d >= 0) run = __fadd_rn(run, cost[p - d]);
          rg.run(ring, b, k, d)[p] = run;
        }
      }
    }
  };

  if (!consumer) {
    produce(0);
  } else {
    if (kDwell && tid < L) sdp[tid] = sdp_g[tid];
    for (int p = tid; p < W; p += kConsumerThreads)
      prev_buf[p] = p == 0 ? 0.0f : kBig;
  }
  __syncthreads();

  // consumer state; consumer thread kFoldThreads + p owns band row p
  const int p = tid - kFoldThreads;
  const bool row = p >= 0 && p < kStagedMaxBand;
  int cur = 0, prev_start = 0, prev_valid = 1;
  for (int c = 0; c < n_chunks; ++c) {
    if (!consumer) {
      if (c + 1 < n_chunks) produce(c + 1);
    } else {
      const int b = c & 1;
      const int n0 = c * chunk;
      const int cnt = min(chunk, N - n0);
      if (c == 0) {
        // spoofed carry for the first base: bsd = 1, width w[0]
        prev_start = rg.st(ring, 0)[0] - 1;
        prev_valid = rg.wd(ring, 0)[0];
      }
      for (int k = 0; k < cnt; ++k) {
        const int st = rg.st(ring, b)[k];
        const int w = rg.wd(ring, b)[k];
        const int nan_row = rg.nan_row(ring, b)[k];
        const float* base = rg.run(ring, b, k, 0);
        const float* prev = prev_buf + cur * Wp;
        float* next = prev_buf + (cur ^ 1) * Wp;
        const int bsd = st - prev_start;
        const float prev_last = prev[prev_valid - 1];
        const bool entry_bsd0 = bsd == 0;
        const int move_limit = min(prev_valid - bsd, w - 1);

        // move candidates (_move_entries)
        if (row && p < w) {
          const float bc = base[p];
          const int src = p - 1 + bsd;
          float mv = (src >= 0 && src < prev_valid)
                         ? __fadd_rn(prev[src], bc)
                         : kBig;
          const bool at_entry = p == 0 && entry_bsd0;
          if (at_entry) mv = __fadd_rn(kLargeScore, prev_last);
          if (!(p <= move_limit || p == 0)) mv = kBig;
          // from the first NaN cost on, fminf folds to NaN as the select
          if (p >= nan_row) mv = __int_as_float(0x7fffffff);
          cand[p] = mv;
          ctb[p] = at_entry ? -1 : 0;
        }
        consumers_sync();
        if (!kDwell) {
          if (tid == 0) fold_rows(base, cand, ctb, next, ctb, w);
        } else {
          // thread 0 runs the unpenalized Viterbi pass (kept for the
          // long-dwell candidate) while every thread takes its row's
          // short-dwell candidates (_dwell_candidates), which need only the
          // previous base's scores and the staged run sums
          if (tid == 0) fold_rows(base, cand, ctb, unpen, unpen_tb, w);
          const int p0 = prev_valid - bsd + L;
          const int p0c = max(p0, 1);
          float curr = __fadd_rn(kLargeScore, prev_last);
          int pick = -1;
          float run = 0.0f;
          if (row && p < w) {
            run = base[p];
            for (int d = 0; d < L; ++d) {
              run = rg.run(ring, b, k, d)[p];
              const int prev_idx = p - d - 1 + bsd;
              const bool valid = p < p0 && p >= d &&
                                 !(entry_bsd0 && p == d) &&
                                 !(p == 0 && entry_bsd0) && prev_idx >= 0 &&
                                 prev_idx < prev_valid;
              if (valid) {
                const float cd =
                    __fadd_rn(__fadd_rn(prev[prev_idx], run), sdp[d]);
                if (cd < curr) {
                  curr = cd;
                  pick = d;
                }
              }
            }
          }
          consumers_sync();
          // the long-dwell candidate; rows below p0c take their candidate
          // whatever the carry, so they are copied into the new scores here
          if (row && p < w) {
            if (p < p0 && p >= L) {
              const float cd = __fadd_rn(unpen[p - L], run);
              if (cd < curr) {
                curr = cd;
                pick = unpen_tb[p - L] + L;
              }
            }
            cand[p] = curr;
            ctb[p] = pick;
            if (p < p0c) next[p] = curr;
          }
          consumers_sync();
          // the past-band suffix: a stay-only running sum
          if (tid == 0 && p0c < w) stay_suffix(base, cand, ctb, next, p0c, w);
        }
        consumers_sync();

        // the base's traceback row; thread p rewrites its own cand and ctb
        // rows next base, so no barrier follows
        if (row && p < W) {
          tb_r[static_cast<int64_t>(n0 + k) * W + p] =
              p < w ? static_cast<int16_t>(ctb[p]) : int16_t(0);
        }
        prev_start = st;
        prev_valid = w;
        cur ^= 1;
      }
    }
    __syncthreads();
  }
}

template <bool kDwell>
int launch_staged(const float* signal, const float* levels, const int* starts,
                const int* widths, const float* sdp, int L, int R, int N,
                int S, int W, int16_t* tb, cudaStream_t s) {
  const int Wp = round4(W);
  const int n_run = kDwell ? max(L, 1) : 1;
  const int per_base = static_cast<int>(sizeof(float)) * 2 *
                       (ring_buf_words(1, n_run, Wp));
  const int chunk = max(1, min(kMaxChunk, kRingBudget / per_base));
  const size_t smem =
      sizeof(float) * (6 * static_cast<size_t>(Wp) +
                       2 * static_cast<size_t>(ring_buf_words(chunk, n_run,
                                                              Wp)));
  cudaError_t err = cudaFuncSetAttribute(
      dp_forward_staged_kernel<kDwell>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dp_forward_staged_kernel<kDwell><<<R, kStagedThreads, smem, s>>>(
      signal, levels, starts, widths, sdp, L, N, S, W, chunk, tb);
  return static_cast<int>(cudaGetLastError());
}

// ---------------- K5, the traceback walk ----------------
//
// Replaces pallas_dp.py::_traceback_kernel, which prefetches each base's
// row by DMA into a two-deep VMEM buffer while the previous base is
// walked. The walk is one serial chain per read: row i's entry depends on
// the value row i + 1's entry gave. Its first design (one thread a read,
// two dependent device-memory loads a step) paid ~1,000 cycles a step.
// Here one block walks one read:
//   * a producer warp (warp 1) fills a ring of `stages` stages in shared
//     memory, a chunk of `chunk` rows a stage in descending base order:
//     the rows by one TMA 1-D bulk copy (cp.async.bulk ...
//     mbarrier::complete_tx), the chunk's band starts by 4-byte cp.async
//     whose completion arrives on the same full mbarrier
//     (cp.async.mbarrier.arrive.noinc), so no lane of the warp waits on
//     device memory. The first chunk ends at row sl - 1, so no padding
//     row is streamed; row 0 is never read. Stage slot j holds row top -
//     j of its chunk (slot 0 the chunk's top row). The warp also writes
//     each chunk's path out once the walker releases it (its empty
//     mbarrier), and the path's ends (path[0] = 0, path[i] = the signal
//     end for i >= sl);
//   * one walker thread (lane 0 of warp 0) waits once a chunk on its full
//     barrier, walks its rows from shared memory alone, four a group
//     (each group's starts one 16-byte load a group ahead, its path
//     values one 16-byte store), and arrives once a chunk on its empty
//     barrier. A last chunk of fewer rows is walked to the next multiple
//     of 4 on stale slots of its own stage, whose values are never
//     written out; each stage's starts end in 4 pad slots, so the last
//     group's look-ahead load stays in its stage too.
// The step, with lookup = path[i + 1] - 1, d = lookup - start[i]:
//     off = clamp(d, 0, W - 1); v = tb[i][off]; path[i] = lookup - v;
//     lookup' = lookup - v - 1; d' = (lookup - (start[i - 1] + 1)) - v.
// Everything but v is known a step ahead, so the dependent chain is
//     LDS.S16 v -> IADD3 d' -> clamp (VIMNMX.RELU, __vimin_s32_relu, one
//     DPX instruction) -> LEA or IMAD (the row's address + 2 off) ->
//     LDS.S16,
// 23 cycles for the LDS (a dependent shared-memory load on an H100) and
// ~4-5 for each of the three integer ops, against a floor of one LDS and
// one add, 27 cycles (chip_dp_variants.py --traceback measures the LDS,
// splits the kernel and prints the loop's SASS). Int32 arithmetic wraps
// as the plain version's does, so paths equal it bit for bit on any
// input: an int16 step of any sign or size, a path that leaves the band,
// sl clamped to [1, N].

constexpr int kTbThreads = 64;              // warp 0 walks, warp 1 stages
constexpr int kTbStageBytes = 32 * 1024;    // tb bytes a stage holds
constexpr int kTbRingBytes = 96 * 1024;     // tb bytes of the ring
constexpr int kTbMaxChunk = 256;            // rows a stage
constexpr int kTbMaxStages = 8;

struct TbRing {
  int chunk, stages;
};

// rows a stage (a multiple of 4) and stages of the ring for rows of W
// int16 (a multiple of 16 bytes); at W = 128, 3 stages of 128 rows
__host__ __device__ __forceinline__ TbRing tb_ring(int W) {
  const int row = 2 * W;
  const int chunk = max(4, min(kTbMaxChunk, kTbStageBytes / row) & ~3);
  return {chunk, max(2, min(kTbMaxStages, kTbRingBytes / (chunk * row)))};
}

// start slots past a stage's last row: the walker's last group reads one
// group of starts ahead, and that read stays inside its own stage
constexpr int kTbStartPad = 4;

// tb rows, then the starts (with their pad) and the path values of each
// stage
__host__ __forceinline__ size_t tb_smem_bytes(TbRing ring, int W) {
  return static_cast<size_t>(ring.stages) *
         (ring.chunk * (2 * static_cast<size_t>(W) + 2 * sizeof(int)) +
          kTbStartPad * sizeof(int));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// an arrival on `bar` once this thread's earlier cp.async copies land
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA 1-D bulk copy, global -> shared; completes `bytes` on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ int lds_s16(uint32_t addr) {
  int v;
  asm volatile("ld.shared.s16 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// One walk step on the row at shared address `row`: see the note above.
// `next_start` is the start of the row walked next.
__device__ __forceinline__ int walk_step(uint32_t row, int next_start,
                                         int W, int& d, uint32_t& lookup) {
  const uint32_t ahead = lookup - (static_cast<uint32_t>(next_start) + 1u);
  const int off = __vimin_s32_relu(d, W - 1);
  const int v = lds_s16(row + 2 * off);
  const uint32_t value = lookup - static_cast<uint32_t>(v);
  d = static_cast<int>(ahead - static_cast<uint32_t>(v));
  lookup = value - 1u;
  return static_cast<int>(value);
}

__global__ void __launch_bounds__(kTbThreads)
    dp_traceback_staged_kernel(const int16_t* __restrict__ tb,
                               const int* __restrict__ starts,
                               const int* __restrict__ widths,
                               const int* __restrict__ seq_lens, int N, int W,
                               int chunk, int stages,
                               int* __restrict__ path) {
  extern __shared__ __align__(128) unsigned char tb_smem[];
  __shared__ __align__(8) uint64_t full[kTbMaxStages];
  __shared__ __align__(8) uint64_t empty[kTbMaxStages];
  const int row_bytes = 2 * W;
  const int stage_bytes = chunk * row_bytes;
  const int st_stride = chunk + kTbStartPad;
  int* st_buf = reinterpret_cast<int*>(tb_smem + stages * stage_bytes);
  int* path_buf = st_buf + stages * st_stride;

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int* st_r = starts + static_cast<int64_t>(r) * N;
  const int* wd_r = widths + static_cast<int64_t>(r) * N;
  const unsigned char* tb_r =
      reinterpret_cast<const unsigned char*>(tb + static_cast<int64_t>(r) *
                                                      N * W);
  int* path_r = path + static_cast<int64_t>(r) * (N + 1);
  const int sl = min(max(seq_lens[r], 1), N);
  // rows sl - 1 .. 1 are walked, `chunk` a stage from the top
  const int n_chunks = (sl - 1 + chunk - 1) / chunk;

  if (tid < stages * kTbStartPad)
    st_buf[(tid / kTbStartPad) * st_stride + chunk + tid % kTbStartPad] = 0;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], 1);  // the walker
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 32) {
    // the producer warp
    const int sig_end = st_r[sl - 1] + wd_r[sl - 1];
    for (int i = sl + lane; i <= N; i += 32) path_r[i] = sig_end;
    if (lane == 0) path_r[0] = 0;
    for (int c = 0; c < n_chunks + stages; ++c) {
      if (c >= stages) {
        // chunk c - stages is walked: write its path out, free its stage
        const int done = c - stages;
        const int s = done % stages;
        mbar_wait(&empty[s], (done / stages) & 1);
        const int top = sl - 1 - done * chunk;
        const int cnt = min(chunk, top);
        for (int j = lane; j < cnt; j += 32)
          path_r[top - j] = path_buf[s * chunk + j];
      }
      if (c >= n_chunks) continue;
      const int s = c % stages;
      const int top = sl - 1 - c * chunk;
      const int cnt = min(chunk, top);
      if (lane == 0) {
        // rows top - cnt + 1 .. top into the stage's last cnt slots' rows
        const uint32_t bytes = static_cast<uint32_t>(cnt * row_bytes);
        mbar_expect_tx(&full[s], bytes);
        bulk_copy(tb_smem + s * stage_bytes + (chunk - cnt) * row_bytes,
                  tb_r + static_cast<int64_t>(top - cnt + 1) * row_bytes,
                  bytes, &full[s]);
      }
      for (int j = lane; j < cnt; j += 32)
        cp_async4(st_buf + s * st_stride + j, st_r + top - j);
      mbar_arrive_cp_async(&full[s]);
    }
  } else if (tid == 0) {
    // the walker: shared memory alone on its chain
    uint32_t lookup =
        static_cast<uint32_t>(st_r[sl - 1] + wd_r[sl - 1]) - 1u;
    const uint32_t ring = smem_u32(tb_smem);
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % stages;
      const int cnt = min(chunk, sl - 1 - c * chunk);
      const int4* st4 =
          reinterpret_cast<const int4*>(st_buf + s * st_stride);
      int4* path4 = reinterpret_cast<int4*>(path_buf + s * chunk);
      // slot j's row: the stage's last row minus j rows
      uint32_t row = ring + s * stage_bytes + (chunk - 1) * row_bytes;
      mbar_wait(&full[s], (c / stages) & 1);
      int4 cur = st4[0];
      int d = static_cast<int>(lookup - static_cast<uint32_t>(cur.x));
      for (int g = 0; g < cnt; g += 4) {
        // the next group's starts; the last group's read lands in the
        // stage's pad or its stale slots, and its d is recomputed at the
        // next chunk's head
        const int4 ahead = st4[g / 4 + 1];
        int4 out;
        out.x = walk_step(row, cur.y, W, d, lookup);
        out.y = walk_step(row - row_bytes, cur.z, W, d, lookup);
        out.z = walk_step(row - 2 * row_bytes, cur.w, W, d, lookup);
        out.w = walk_step(row - 3 * row_bytes, ahead.x, W, d, lookup);
        path4[g / 4] = out;
        row -= 4 * row_bytes;
        cur = ahead;
      }
      mbar_arrive(&empty[s]);
    }
  }
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the staged path's folds write rows up to w's next multiple of 8
  if (W <= kStagedMaxBand && W % 8 == 0) {
    return dwell ? launch_staged<true>(signal, levels, starts, widths, sdp, L,
                                     R, N, S, W, tb, s)
                 : launch_staged<false>(signal, levels, starts, widths, sdp, L,
                                      R, N, S, W, tb, s);
  }
  const size_t smem = static_cast<size_t>(W) * 4 * (dwell ? 6 : 4);
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

// K5. tb (R, N, W) int16 (16-byte aligned, W a multiple of 8), starts /
// widths (R, N), seq_lens (R,) -> path (R, N + 1) int32. Returns a
// cudaError_t (0 on a clean launch).
int banded_dp_traceback(const int16_t* tb, const int* starts,
                        const int* widths, const int* seq_lens, int R, int N,
                        int W, int* path, void* stream) {
  if (R <= 0) return 0;
  if (N <= 0 || W <= 0 || W > kMaxBand || W % 8 != 0 ||
      reinterpret_cast<uintptr_t>(tb) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const TbRing ring = tb_ring(W);
  const size_t smem = tb_smem_bytes(ring, W);
  cudaError_t err = cudaFuncSetAttribute(
      dp_traceback_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dp_traceback_staged_kernel<<<R, kTbThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      tb, starts, widths, seq_lens, N, W, ring.chunk, ring.stages, path);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
