"""Banded Viterbi / dwell-penalty dynamic program (host reference impl);
copy of ``remora_tpu/refine/dp.py``.

Reference analog: ``src/remora/refine_signal_map_core.pyx`` (505 LoC of
Cython). Semantics preserved exactly, including tie-breaking (move wins
only on strictly smaller score; dwell candidates are scanned in
ascending dwell order with strict improvement) and the invalid-entry
sentinel ``LARGE_SCORE + prev[-1]``.

Exactness note: the stay chain ``curr[p] = min(entry[p], curr[p-1] +
base[p])`` is algebraically a min-plus prefix scan — ``curr[p] = B[p] +
min_{q<=p}(entry[q] - B[q])`` with inclusive cumsum ``B`` — and that
reformulation is what the JAX package's batched lax.scan kernel
vectorizes. But in float32 the prefix-sum
association differs from the C sequential adds, and at long-read/
wide-band geometry a rare tie flips one path position (observed: 1 of
1891 at max_seq=2000, bhw=9). This host module therefore runs the stay
chains and stay-run sums SEQUENTIALLY in f32, matching the reference
Cython association bit-for-bit (like the native C++ core and the
device kernels of ``kernels/banded_dp.py``, which fold stays
sequentially); entry/move candidates stay vectorized — the band is only
~2*bhw+1 wide, so the per-base Python chain over it costs little on this
fallback path.
"""

import numpy as np

from remora_tpu_torch import RemoraError
from remora_tpu_torch.constants import (
    REFINE_ALGO_DWELL_PEN_NAME,
    REFINE_ALGO_VIT_NAME,
)

LARGE_SCORE = np.float32(100.0)
HUGE = np.float32(np.finfo(np.float32).max)


def _band_costs(signal, level):
    d = signal - level
    return d * d


def _vit_step_fast(prev_scores, level, curr_signal, bsd):
    """_vit_step with vectorized entries and an EXACT sequential stay
    chain (f32 adds in reference order; the band is narrow)."""
    W = curr_signal.shape[0]
    base = _band_costs(curr_signal, level).astype(np.float32)
    entry = np.full(W, np.float32(np.inf), dtype=np.float32)
    entry_tb0 = -1 if bsd == 0 else 0
    if bsd == 0:
        entry[0] = LARGE_SCORE + prev_scores[-1]
    else:
        entry[0] = prev_scores[bsd - 1] + base[0]
    n_move = min(prev_scores.shape[0] - bsd, W - 1)
    if n_move > 0:
        ps = np.arange(1, n_move + 1)
        entry[ps] = prev_scores[ps - 1 + bsd] + base[ps]
    curr = np.empty(W, dtype=np.float32)
    tb = np.empty(W, dtype=np.int32)
    curr[0] = entry[0]
    tb[0] = entry_tb0
    # sequential stay chain: curr[p] = min(entry[p], curr[p-1] + base[p])
    # with move winning only on strict improvement — bit-exact vs the
    # reference C association (a cummin-over-prefix-sums reformulation
    # reassociates the adds and can flip rare ties)
    for p in range(1, W):
        stay = np.float32(curr[p - 1] + base[p])
        mv = entry[p]
        if mv < stay:
            curr[p] = mv
            tb[p] = 0
        else:
            curr[p] = stay
            tb[p] = tb[p - 1] + 1
    return curr, tb


def _dwell_pen_step(prev_scores, level, curr_signal, bsd, sdp):
    """One base of the dwell-penalty pass (vectorized over the band)."""
    W = curr_signal.shape[0]
    L = sdp.shape[0]
    base = _band_costs(curr_signal, level).astype(np.float32)
    # unpenalized Viterbi scores for the long-dwell fallback
    unpen, unpen_tb = _vit_step_fast(prev_scores, level, curr_signal, bsd)

    invalid = LARGE_SCORE + prev_scores[-1]
    curr = np.full(W, invalid, dtype=np.float32)
    tb = np.full(W, -1, dtype=np.int32)

    p = np.arange(W)
    # suffix stay-only region: positions past the previous band by >= L
    p0 = prev_scores.shape[0] - bsd + L
    main = p < p0

    # penalized candidates for dwell_idx d (ascending; strict
    # improvement). run[p] accumulates base[p] + base[p-1] + ... +
    # base[p-d] one term per round — the reference's
    # running_pos_score association exactly (a prefix-sum difference
    # reassociates and can flip rare ties)
    run = base.copy()
    for d in range(L):
        if d > 0:
            run[d:] = run[d:] + base[: W - d]
        prev_idx = p - d - 1 + bsd
        valid = (
            main
            & (d <= p)
            & ~((bsd == 0) & (p == d))
            & ~((bsd == 0) & (p == 0))
            & (prev_idx >= 0)
            & (prev_idx < prev_scores.shape[0])
        )
        if not valid.any():
            continue
        vp = p[valid]
        cand = prev_scores[prev_idx[valid]] + run[vp] + sdp[d]
        upd = cand < curr[vp]
        curr[vp[upd]] = cand[upd]
        tb[vp[upd]] = d
    # unpenalized long-dwell candidate (run now holds the full L-term
    # stay sums)
    long_ok = main & (p >= L)
    if long_ok.any():
        vp = p[long_ok]
        cand = unpen[vp - L] + run[vp]
        upd = cand < curr[vp]
        curr[vp[upd]] = cand[upd]
        tb[vp[upd]] = unpen_tb[vp[upd] - L] + L
    # stay-only suffix: sequential accumulation from the last main
    # position (reference order)
    if p0 < W:
        p0c = max(p0, 1)
        for q in range(p0c, W):
            curr[q] = np.float32(curr[q - 1] + base[q])
            tb[q] = tb[q - 1] + 1
    return curr, tb


def banded_forward_dp(signal, levels, seq_band, short_dwell_penalty,
                      core_method=REFINE_ALGO_VIT_NAME):
    """Forward pass over all bases; returns ragged (all_scores, traceback,
    base_offsets)."""
    if core_method == REFINE_ALGO_VIT_NAME:
        step = lambda prev, lvl, sig, bsd: _vit_step_fast(prev, lvl, sig, bsd)
    elif core_method == REFINE_ALGO_DWELL_PEN_NAME:
        step = lambda prev, lvl, sig, bsd: _dwell_pen_step(
            prev, lvl, sig, bsd, short_dwell_penalty
        )
    else:
        raise RemoraError(
            f"Invalid core signal mapping refine method: {core_method}"
        )

    widths = (seq_band[1] - seq_band[0]).astype(np.int64)
    base_offsets_raw = np.cumsum(widths)
    band_len = int(base_offsets_raw[-1])
    if band_len > np.iinfo(np.uint32).max:
        raise RemoraError(
            "Dynamic programming search space too large. Read likely "
            "contains large deletions."
        )
    base_offsets = np.empty(seq_band.shape[1] + 1, dtype=np.uint32)
    base_offsets[0] = 0
    base_offsets[1:] = base_offsets_raw
    all_scores = np.empty(band_len, dtype=np.float32)
    traceback = np.empty(band_len, dtype=np.int32)

    # first base: spoofed stay-only prev scores
    curr_bw = int(seq_band[1, 0])
    prev = np.full(curr_bw, HUGE, dtype=np.float32)
    prev[0] = 0
    curr, tb = step(prev, levels[0], signal[:curr_bw], 1)
    all_scores[:curr_bw] = curr
    traceback[:curr_bw] = tb
    prev_band_st = 0
    prev_scores = curr

    for base_idx in range(1, levels.shape[0]):
        st = int(seq_band[0, base_idx])
        en = int(seq_band[1, base_idx])
        off = int(base_offsets[base_idx])
        curr, tb = step(
            prev_scores, levels[base_idx], signal[st:en], st - prev_band_st
        )
        all_scores[off : off + en - st] = curr
        traceback[off : off + en - st] = tb
        prev_scores = curr
        prev_band_st = st
    return all_scores, traceback, base_offsets


def banded_traceback(seq_band, base_offsets, traceback):
    """Reconstruct the base-start path from the traceback array."""
    seq_len = seq_band.shape[1]
    path = np.empty(seq_len + 1, dtype=np.int32)
    path[0] = 0
    path[-1] = seq_band[1, -1]
    for base_idx in range(seq_len - 1, 0, -1):
        sig_lookup = path[base_idx + 1] - 1
        next_off = traceback[
            int(base_offsets[base_idx]) + sig_lookup - seq_band[0, base_idx]
        ]
        path[base_idx] = sig_lookup - next_off
    return path


def seq_banded_dp(signal, levels, seq_band, short_dwell_penalty,
                  core_method=REFINE_ALGO_VIT_NAME):
    """Full decode: forward pass + traceback.

    Returns (all_scores, path, traceback, base_offsets) — same shape
    contract as the reference Cython ``seq_banded_dp``.
    """
    all_scores, traceback, base_offsets = banded_forward_dp(
        np.asarray(signal, dtype=np.float32),
        np.asarray(levels, dtype=np.float32),
        seq_band,
        np.asarray(short_dwell_penalty, dtype=np.float32),
        core_method,
    )
    path = banded_traceback(seq_band, base_offsets, traceback)
    return all_scores, path, traceback, base_offsets
