// Theil-Sen pairwise-slope median for signal rescaling.
//
// The port's copy of csrc/rescale.cpp. Same math as the numpy path in
// remora_tpu_torch/refine/rescale.py
// (reference analog: src/remora/refine_signal_map.py:101-121): over all
// point pairs with distinct event means, the slope multiset
// {(m_i - m_j) / (e_i - e_j) : e_i != e_j} is orientation-invariant in
// IEEE arithmetic, so collecting each unordered pair once yields the
// identical multiset the full-matrix numpy mask produces; the median
// (mean of the two middle elements for even counts, matching
// np.median) is then selected with nth_element instead of allocating
// three n^2 matrices.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// Returns the median pairwise slope; NaN when no valid pair exists.
double theil_sen_median_slope(const double* e, const double* m, int64_t n) {
    std::vector<double> slopes;
    slopes.reserve((size_t)n * (n - 1) / 2);
    bool has_nan = false;
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t j = i + 1; j < n; ++j) {
            double de = e[i] - e[j];
            // NaN event deltas fail both comparisons, matching the
            // numpy delta > 0 mask
            if (de > 0.0 || de < 0.0) {
                double s = (m[i] - m[j]) / de;
                has_nan |= std::isnan(s);
                slopes.push_back(s);
            }
        }
    }
    size_t ns = slopes.size();
    if (ns == 0 || has_nan)
        return std::numeric_limits<double>::quiet_NaN();
    size_t mid = ns / 2;
    std::nth_element(slopes.begin(), slopes.begin() + mid, slopes.end());
    double hi = slopes[mid];
    if (ns % 2 == 1) return hi;
    double lo = *std::max_element(slopes.begin(), slopes.begin() + mid);
    return (lo + hi) / 2.0;
}

}  // extern C
