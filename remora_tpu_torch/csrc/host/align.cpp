// Semi-global pairwise alignment with affine gaps (parasail sg_qx analog).
//
// The full query aligns against a window of the reference: leading and
// trailing reference overhangs (gaps in the query row at either end) are
// free, interior gaps affine. EDNAFULL-style scoring: match +5, mismatch
// -4, any comparison involving a non-ACGT code -2. Gap of length L costs
// open + extend * L (parasail convention, defaults open=10 extend=2).
//
// Used by remora_tpu_torch.io.duplex (reference analog: parasail
// sg_qx_trace_scan_32 in src/remora/duplex_utils.py:62-86). The port's
// copy of csrc/align.cpp, built into the port's host library with the
// other csrc/host sources (io/native.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t NEG_INF = -0x3f3f3f3f;

inline int32_t score(char a, char b) {
    bool a_ok = a == 'A' || a == 'C' || a == 'G' || a == 'T';
    bool b_ok = b == 'A' || b == 'C' || b == 'G' || b == 'T';
    if (!a_ok || !b_ok) return -2;
    return a == b ? 5 : -4;
}

// per-cell packed traceback: bits 0-1 H source (0 diag, 1 E, 2 F),
// bit 2 E extended (else opened), bit 3 F extended (else opened)
enum : uint8_t {
    H_DIAG = 0,
    H_E = 1,
    H_F = 2,
    E_EXT = 4,
    F_EXT = 8,
};

}  // namespace

extern "C" {

// Align query against ref. Writes cigar (ops: 0=M, 1=I(query-only),
// 2=D(ref-only)) and out_coords = {ref_start, ref_end, query_start,
// query_end} with leading/trailing indels trimmed so the cigar starts
// and ends on M runs. Returns number of ops, or -1 on error / overflow.
int sg_align(const char* query, int32_t qlen, const char* ref, int32_t rlen,
             int32_t gap_open, int32_t gap_extend, int32_t* cigar_ops,
             int32_t* cigar_lens, int32_t max_ops, int32_t* out_coords) {
    if (qlen <= 0 || rlen <= 0) return -1;
    const int64_t W = (int64_t)rlen + 1;
    const int32_t goe = gap_open + gap_extend;

    std::vector<int32_t> Hprev(W), Hcur(W), Fprev(W), Fcur(W), E(W);
    std::vector<uint8_t> tb((int64_t)(qlen + 1) * W, 0);

    for (int32_t j = 0; j <= rlen; ++j) {
        Hprev[j] = 0;  // free leading ref overhang
        Fprev[j] = NEG_INF;
    }

    for (int32_t i = 1; i <= qlen; ++i) {
        uint8_t* tbrow = &tb[(int64_t)i * W];
        // column 0: leading query gap (I) penalized, affine
        Fcur[0] = (Fprev[0] == NEG_INF) ? -goe : Fprev[0] - gap_extend;
        if (Hprev[0] - goe > Fcur[0]) Fcur[0] = Hprev[0] - goe;
        Hcur[0] = Fcur[0];
        E[0] = NEG_INF;
        tbrow[0] = H_F | ((i > 1) ? F_EXT : 0);
        const char qc = query[i - 1];
        for (int32_t j = 1; j <= rlen; ++j) {
            uint8_t cell = 0;
            // E: gap in query (D op, consume ref), within-row
            int32_t e_open = Hcur[j - 1] - goe;
            int32_t e_ext = E[j - 1] - gap_extend;
            if (e_ext > e_open) {
                E[j] = e_ext;
                cell |= E_EXT;
            } else {
                E[j] = e_open;
            }
            // F: gap in ref (I op, consume query), from previous row
            int32_t f_open = Hprev[j] - goe;
            int32_t f_ext = Fprev[j] - gap_extend;
            if (f_ext > f_open) {
                Fcur[j] = f_ext;
                cell |= F_EXT;
            } else {
                Fcur[j] = f_open;
            }
            // H
            int32_t h = Hprev[j - 1] + score(qc, ref[j - 1]);
            uint8_t hsrc = H_DIAG;
            if (E[j] > h) {
                h = E[j];
                hsrc = H_E;
            }
            if (Fcur[j] > h) {
                h = Fcur[j];
                hsrc = H_F;
            }
            Hcur[j] = h;
            tbrow[j] = cell | hsrc;
        }
        std::swap(Hprev, Hcur);
        std::swap(Fprev, Fcur);
    }
    // Hprev now holds row qlen. Free trailing ref overhang: best over j,
    // preferring the largest j on ties (matches covering more reference).
    int32_t best_j = 0, best = NEG_INF;
    for (int32_t j = 0; j <= rlen; ++j) {
        if (Hprev[j] >= best) {
            best = Hprev[j];
            best_j = j;
        }
    }

    // traceback from (qlen, best_j) in state H
    std::vector<int32_t> rops, rlens;
    auto push = [&](int32_t op) {
        if (!rops.empty() && rops.back() == op) {
            rlens.back() += 1;
        } else {
            rops.push_back(op);
            rlens.push_back(1);
        }
    };
    int32_t i = qlen, j = best_j;
    int state = 0;  // 0=H, 1=E, 2=F
    while (i > 0) {
        uint8_t cell = tb[(int64_t)i * W + j];
        if (state == 0) {
            uint8_t hsrc = cell & 3;
            if (hsrc == H_DIAG) {
                push(0);
                --i;
                --j;
            } else if (hsrc == H_E) {
                state = 1;
            } else {
                state = 2;
            }
        } else if (state == 1) {
            push(2);
            state = (cell & E_EXT) ? 1 : 0;
            --j;
        } else {
            push(1);
            state = (cell & F_EXT) ? 2 : 0;
            --i;
        }
        if (j < 0) return -1;
    }
    // i == 0: remaining ref prefix [0, j) is the free leading overhang
    int32_t ref_start = j, ref_end = best_j;
    int32_t query_start = 0, query_end = qlen;

    // cigar currently reversed; also trim leading/trailing indels
    int32_t n = (int32_t)rops.size();
    int32_t lo = 0, hi = n;  // over reversed array: index 0 = alignment END
    // trim alignment-start ops (at the END of the reversed arrays)
    while (hi > lo) {
        int32_t op = rops[hi - 1], len = rlens[hi - 1];
        if (op == 1) {
            query_start += len;
            --hi;
        } else if (op == 2) {
            ref_start += len;
            --hi;
        } else {
            break;
        }
    }
    // trim alignment-end ops (at the START of the reversed arrays)
    while (hi > lo) {
        int32_t op = rops[lo], len = rlens[lo];
        if (op == 1) {
            query_end -= len;
            ++lo;
        } else if (op == 2) {
            ref_end -= len;
            ++lo;
        } else {
            break;
        }
    }
    int32_t out_n = hi - lo;
    if (out_n <= 0 || out_n > max_ops) return -1;
    for (int32_t k = 0; k < out_n; ++k) {
        cigar_ops[k] = rops[hi - 1 - k];
        cigar_lens[k] = rlens[hi - 1 - k];
    }
    out_coords[0] = ref_start;
    out_coords[1] = ref_end;
    out_coords[2] = query_start;
    out_coords[3] = query_end;
    return out_n;
}

}  // extern C
