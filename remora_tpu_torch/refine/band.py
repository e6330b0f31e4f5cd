"""Band construction for the refinement DP (all vectorized NumPy); copy of
``remora_tpu/refine/band.py``.

Reference analogs: ``compute_sig_band`` / ``convert_to_seq_band`` /
``validate_band`` (``src/remora/refine_signal_map.py:634–770``) and the
Cython ``adjust_seq_band`` (``refine_signal_map_core.pyx:31–69``) — the
latter's sequential min-step repair is re-derived here as closed-form
reverse/forward cumulative extrema so it vectorizes (and ports directly
to a TPU scan).
"""

import numpy as np

from remora_tpu_torch import RemoraError, log
from remora_tpu_torch.constants import DEFAULT_REFINE_HBW

LOGGER = log.get_logger()


def compute_sig_band(bps, levels, bhw=DEFAULT_REFINE_HBW, is_banded=True):
    """Band in sequence coordinates at each signal position.

    NaN levels pin the band to the current path so the DP cannot reassign
    signal around un-scored bases.
    """
    if is_banded and bhw is None:
        raise RemoraError("Cannot compute band with half width of None.")
    seq_len = levels.size
    if bps.size != seq_len + 1:
        raise RemoraError("Breakpoints must be one longer than levels.")
    # the base currently assigned to every signal position
    base_at_sig = np.repeat(np.arange(seq_len), np.diff(bps))

    if is_banded:
        lo = np.clip(base_at_sig - bhw, 0, None)
        hi = np.clip(base_at_sig + bhw + 1, None, seq_len)
    else:
        lo = np.zeros(base_at_sig.size, dtype=np.int64)
        hi = np.full(base_at_sig.size, seq_len, dtype=np.int64)

    pinned = np.isnan(levels)[base_at_sig]
    lo[pinned] = base_at_sig[pinned]
    hi[pinned] = base_at_sig[pinned] + 1
    # pinning may have broken monotonicity; restore it in both directions
    lo = np.maximum.accumulate(lo)
    hi = np.minimum.accumulate(hi[::-1])[::-1]
    return np.stack([lo, hi]).astype(np.int32)


def convert_to_seq_band(sig_band):
    """Transpose a per-signal band into per-base signal-coordinate bounds.

    Base b is inside the band at signal i iff lo[i] <= b < hi[i]; since
    both bounds are monotone the per-base window is a pair of
    searchsorted lookups: entry = first i with hi[i] > b, exit = one past
    the last i with lo[i] <= b.
    """
    seq_len = int(sig_band[1, -1])
    bases = np.arange(seq_len)
    entries = np.searchsorted(sig_band[1], bases, side="right")
    exits = np.searchsorted(sig_band[0], bases, side="right")
    return np.stack([entries, exits]).astype(np.int32)


def adjust_seq_band(seq_band, min_step=2):
    """Repair a seq band so every base advances by at least ``min_step``.

    In-place, matching the Cython semantics:
      1. backward pass pulls starts down: start[i] <= start[i+1]-min_step
      2. start[0] restored; a cascading forward prefix enforces strict
         increase from the original first coordinate
      3/4. mirrored for the upper bounds.

    The recurrences unroll to reverse/forward cumulative extrema of
    (bound -/+ min_step * index), so everything is vectorized.
    """
    n = seq_band.shape[1]
    idx = np.arange(n, dtype=np.int64)
    min_step = int(min_step)

    # 1: start[i] = min_{j>=i}(start[j] - min_step*(j-i))
    starts = seq_band[0].astype(np.int64)
    band_min = int(starts[0])
    b = starts - min_step * idx
    rev_cummin = np.minimum.accumulate(b[::-1])[::-1]
    starts = rev_cummin + min_step * idx
    # 2: restore first coordinate, then the cascading forward repair
    # assigns start[j] = band_min + j over the contiguous violating prefix
    # (j >= 1 with start[j] < band_min + j, stopping at first satisfied j)
    starts[0] = band_min
    viol = starts[1:] < band_min + idx[1:]
    if viol.size and viol[0]:
        stop = viol.size if viol.all() else int(np.argmin(viol))
        starts[1 : stop + 1] = band_min + idx[1 : stop + 1]

    # 3: end[i] = max_{j<=i}(end[j] + min_step*(i-j))
    ends = seq_band[1].astype(np.int64)
    band_max = int(ends[-1])
    c = ends - min_step * idx
    cummax = np.maximum.accumulate(c)
    ends = cummax + min_step * idx
    # 4: restore last coordinate, then the cascading backward repair
    # assigns end[j] = band_max - (n-1-j) over the contiguous violating
    # suffix (j <= n-2 with end[j] > band_max - (n-1-j))
    ends[-1] = band_max
    dist = n - 1 - idx
    rev = (ends[:-1] > band_max - dist[:-1])[::-1]
    if rev.size and rev[0]:
        stop = rev.size if rev.all() else int(np.argmin(rev))
        ends[n - 1 - stop : n - 1] = band_max - dist[n - 1 - stop : n - 1]

    seq_band[0] = starts
    seq_band[1] = ends
    return seq_band


def validate_band(band, sig_len=None, seq_len=None, is_sig_band=True):
    lo, hi = band
    if lo[0] != 0:
        raise RemoraError("Band does not start with 0 coordinate.")
    if (hi - lo).min() <= 0:
        raise RemoraError("Band contains 0-length region")
    for bound, which in ((lo, "start"), (hi, "end")):
        if np.diff(bound).min() < 0:
            raise RemoraError(
                f"Band {which} positions are not monotonically increasing"
            )
    # a sig band spans sig_len columns ending at seq_len; a seq band the
    # transpose
    want_cols, want_end = (
        (sig_len, seq_len) if is_sig_band else (seq_len, sig_len)
    )
    kind = "sig_band" if is_sig_band else "seq_band"
    if want_cols is not None and band.shape[1] != want_cols:
        raise RemoraError(f"Invalid {kind} length")
    if want_end is not None and hi[-1] != want_end:
        raise RemoraError(f"Invalid {kind} end coordinate")
