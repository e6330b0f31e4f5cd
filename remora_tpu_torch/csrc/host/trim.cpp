// In-place ragged trim of super-batch chunk rows for a shrunken chunk
// context.
//
// The port's copy of csrc/trim.cpp. Same result as the NumPy path in
// remora_tpu_torch/data/dataset.py::trim_rows_numpy. Behavioral analog
// of the reference Cython kernel (data_chunks_core.pyx:10-45): mapping
// rows arrive already shifted by
// the leading-context difference; each row keeps the base window whose
// signal spans intersect [0, new_width), left-aligned.

#include <cstdint>
#include <cstring>

extern "C" {

void trim_chunk_rows(int16_t* maps, int64_t map_w, int8_t* seqs,
                     int64_t seq_w, int16_t* lens, int64_t n_rows,
                     int32_t new_width, int32_t seq_ctx) {
    for (int64_t r = 0; r < n_rows; ++r) {
        int16_t* m = maps + r * map_w;
        int8_t* q = seqs + r * seq_w;
        const int32_t n = lens[r];
        // first base whose (shifted) end lands beyond 0
        int32_t first = 0;
        while (first < n - 1 && m[first + 1] <= 0) ++first;
        // last base whose start precedes the new width
        int32_t last = n - 1;
        while (last > 0 && m[last] >= new_width) --last;
        const int32_t sl = last - first + 1;
        if (first > 0) {
            std::memmove(m, m + first, (sl + 1) * sizeof(int16_t));
            std::memmove(q, q + first, (size_t)(sl + seq_ctx));
        }
        m[0] = 0;
        m[sl] = (int16_t)new_width;
        for (int32_t j = 1; j < sl; ++j) {
            if (m[j] < 0)
                m[j] = 0;
            else if (m[j] > new_width)
                m[j] = (int16_t)new_width;
        }
        lens[r] = (int16_t)sl;
    }
}

}  // extern "C"
