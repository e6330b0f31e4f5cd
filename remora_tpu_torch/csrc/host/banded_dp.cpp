// Banded Viterbi / dwell-penalty DP for signal-mapping refinement.
//
// Native host kernel: the port's copy of csrc/banded_dp.cpp (the batched
// device kernels are remora_tpu_torch/csrc/banded_dp.cu). Semantics match
// remora_tpu_torch/refine/dp.py (the NumPy ground truth, itself verified
// against a line-for-line oracle of the reference Cython
// refine_signal_map_core.pyx) including tie-breaking and the invalid-entry
// sentinel.
//
// Built into remora_tpu_torch/csrc/build/libremora_torch_host.so together
// with rescale.cpp (io/native.py).

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr float LARGE_SCORE = 100.0f;
constexpr float HUGE_F = 3.0e38f;

inline float sq(float s, float l) {
    float d = s - l;
    return d * d;
}

void vit_step(float* curr, int32_t* tb, const float* prev, int prev_n,
              float level, const float* sig, int band_start_diff, int n) {
    const float* p = prev;
    int pn = prev_n;
    if (band_start_diff == 0) {
        curr[0] = LARGE_SCORE + prev[prev_n - 1];
        tb[0] = -1;
    } else {
        curr[0] = prev[band_start_diff - 1] + sq(level, sig[0]);
        tb[0] = 0;
        p = prev + band_start_diff;
        pn = prev_n - band_start_diff;
    }
    if (pn == n) pn -= 1;
    int band_pos = 1;
    for (; band_pos <= pn; ++band_pos) {
        float base = sq(level, sig[band_pos]);
        float move = p[band_pos - 1] + base;
        float stay = curr[band_pos - 1] + base;
        if (move < stay) {
            curr[band_pos] = move;
            tb[band_pos] = 0;
        } else {
            curr[band_pos] = stay;
            tb[band_pos] = tb[band_pos - 1] + 1;
        }
    }
    for (; band_pos < n; ++band_pos) {
        curr[band_pos] = curr[band_pos - 1] + sq(level, sig[band_pos]);
        tb[band_pos] = tb[band_pos - 1] + 1;
    }
}

void dwell_step(float* curr, int32_t* tb, const float* prev, int prev_n,
                float level, const float* sig, int band_start_diff, int n,
                const float* sdp, int L, float* unpen, int32_t* unpen_tb) {
    vit_step(unpen, unpen_tb, prev, prev_n, level, sig, band_start_diff, n);
    for (int band_pos = 0; band_pos < n; ++band_pos) {
        if (band_pos > 0 && band_pos + band_start_diff - prev_n >= L) {
            curr[band_pos] = curr[band_pos - 1] + sq(level, sig[band_pos]);
            tb[band_pos] = tb[band_pos - 1] + 1;
            continue;
        }
        curr[band_pos] = LARGE_SCORE + prev[prev_n - 1];
        tb[band_pos] = -1;
        if (band_pos == 0 && band_start_diff == 0) continue;
        float running = 0.0f;
        int d;
        for (d = 0; d < L; ++d) {
            if (d > band_pos ||
                (band_start_diff == 0 && band_pos == d))
                break;
            running += sq(level, sig[band_pos - d]);
            int pi = band_pos - d - 1 + band_start_diff;
            if (pi >= prev_n) continue;
            float cand = prev[pi] + running + sdp[d];
            if (cand < curr[band_pos]) {
                curr[band_pos] = cand;
                tb[band_pos] = d;
            }
        }
        if (band_pos >= L) {
            float cand = unpen[band_pos - L] + running;
            if (cand < curr[band_pos]) {
                curr[band_pos] = cand;
                tb[band_pos] = unpen_tb[band_pos - L] + L;
            }
        }
    }
}

}  // namespace

extern "C" {

// seq_band given as two arrays of length seq_len (starts incl, ends excl
// in signal coordinates). Fills path_out (seq_len + 1). Returns 0, or -1
// when the ragged band exceeds limits.
int banded_dp(const float* signal, int32_t sig_len, const float* levels,
              int32_t seq_len, const int32_t* band_starts,
              const int32_t* band_ends, const float* sdp, int32_t sdp_len,
              int32_t use_dwell, int32_t* path_out) {
    if (seq_len <= 0 || sig_len <= 0) return -1;
    // ragged offsets
    std::vector<int64_t> offsets(seq_len + 1);
    offsets[0] = 0;
    int max_w = 0;
    for (int i = 0; i < seq_len; ++i) {
        int w = band_ends[i] - band_starts[i];
        if (w <= 0) return -1;
        if (w > max_w) max_w = w;
        offsets[i + 1] = offsets[i] + w;
    }
    int64_t band_len = offsets[seq_len];
    if (band_len > INT64_C(0xFFFFFFFF)) return -1;
    std::vector<float> scores(band_len);
    std::vector<int32_t> tb(band_len);
    std::vector<float> unpen(max_w);
    std::vector<int32_t> unpen_tb(max_w);

    // first base: spoofed stay-through prev (prev[0]=0, rest huge), bsd=1
    int curr_w = band_ends[0] - band_starts[0];
    std::vector<float> prev0(curr_w, HUGE_F);
    prev0[0] = 0.0f;
    if (use_dwell) {
        dwell_step(scores.data(), tb.data(), prev0.data(), curr_w, levels[0],
                   signal, 1, curr_w, sdp, sdp_len, unpen.data(),
                   unpen_tb.data());
    } else {
        vit_step(scores.data(), tb.data(), prev0.data(), curr_w, levels[0],
                 signal, 1, curr_w);
    }
    int prev_w = curr_w;
    int prev_start = 0;
    int64_t prev_off = 0;
    for (int i = 1; i < seq_len; ++i) {
        int st = band_starts[i];
        curr_w = band_ends[i] - st;
        int64_t off = offsets[i];
        if (use_dwell) {
            dwell_step(scores.data() + off, tb.data() + off,
                       scores.data() + prev_off, prev_w, levels[i],
                       signal + st, st - prev_start, curr_w, sdp, sdp_len,
                       unpen.data(), unpen_tb.data());
        } else {
            vit_step(scores.data() + off, tb.data() + off,
                     scores.data() + prev_off, prev_w, levels[i],
                     signal + st, st - prev_start, curr_w);
        }
        prev_w = curr_w;
        prev_start = st;
        prev_off = off;
    }

    // traceback
    path_out[0] = 0;
    path_out[seq_len] = band_ends[seq_len - 1];
    for (int i = seq_len - 1; i >= 1; --i) {
        int lookup = path_out[i + 1] - 1;
        int32_t step_back = tb[offsets[i] + (lookup - band_starts[i])];
        path_out[i] = lookup - step_back;
    }
    return 0;
}

}  // extern C
