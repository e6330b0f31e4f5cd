"""Per-base signal statistics (dwell / mean / sd and trimmed variants).

Behavioral parity with the reference ``src/remora/metrics.py``, but built
around one generic windowed-moment engine: every metric is a prefix-sum
lookup over per-base signal windows, where the "trimmed" variants simply
shrink each window by fixed offsets. Degenerate (empty) windows yield NaN.

Copy of ``remora_tpu/core/metrics.py``, importing this package's modules.
"""

import numpy as np

DEFAULT_START_TRIM = 1
DEFAULT_END_TRIM = 1


class _BaseWindows:
    """Per-base signal windows with prefix-sum moment queries.

    The signal is first restricted to the span covered by the mapping so
    prefix sums stay small; window edges may then be narrowed by
    (start_trim, end_trim) samples per base.
    """

    def __init__(self, sig, seq_to_sig):
        lo = seq_to_sig[0]
        self.sig = sig[lo : seq_to_sig[-1]]
        self.starts = seq_to_sig[:-1] - lo
        self.ends = seq_to_sig[1:] - lo
        self.full_widths = np.diff(seq_to_sig).astype(np.float32)
        self._cs1 = None
        self._cs2 = None

    @staticmethod
    def _prefix(values):
        out = np.zeros(values.size + 1)
        np.cumsum(values, out=out[1:])
        return out

    def _moments(self, start_trim, end_trim):
        """Windowed (width, sum, sum-of-squares) after edge trimming."""
        if start_trim == 0 and end_trim == 0:
            lo, hi = self.starts, self.ends
            width = self.full_widths
        else:
            lo = np.minimum(self.starts + start_trim, self.sig.size)
            hi = np.maximum(self.ends - end_trim, 0)
            width = np.maximum(self.full_widths - start_trim - end_trim, 0)
        if self._cs1 is None:
            self._cs1 = self._prefix(self.sig)
        return width, self._cs1[hi] - self._cs1[lo], (lo, hi)

    def means(self, start_trim=0, end_trim=0):
        width, total, _ = self._moments(start_trim, end_trim)
        with np.errstate(divide="ignore", invalid="ignore"):
            m = total / width
            m[np.isinf(m)] = np.nan
        return m

    def stdevs(self, means, start_trim=0, end_trim=0):
        width, _, (lo, hi) = self._moments(start_trim, end_trim)
        if self._cs2 is None:
            self._cs2 = self._prefix(np.square(self.sig))
        sq_total = self._cs2[hi] - self._cs2[lo]
        with np.errstate(divide="ignore", invalid="ignore"):
            var = np.maximum(sq_total / width - np.square(means), 0)
            sd = np.sqrt(var)
            sd[np.isinf(sd)] = np.nan
        return sd


def _trims(kwargs):
    return (
        kwargs.get("start_trim", DEFAULT_START_TRIM),
        kwargs.get("end_trim", DEFAULT_END_TRIM),
    )


def compute_dwell(sig, seq_to_sig, **kwargs):
    return {"dwell": np.diff(seq_to_sig).astype(np.float32)}


def compute_dwell_mean(sig, seq_to_sig, **kwargs):
    win = _BaseWindows(sig, seq_to_sig)
    return {"dwell": win.full_widths, "mean": win.means()}


def compute_dwell_mean_sd(sig, seq_to_sig, **kwargs):
    win = _BaseWindows(sig, seq_to_sig)
    means = win.means()
    return {
        "dwell": win.full_widths,
        "mean": means,
        "sd": win.stdevs(means),
    }


def compute_trimmean(sig, seq_to_sig, **kwargs):
    st, en = _trims(kwargs)
    win = _BaseWindows(sig, seq_to_sig)
    # NB: plural "dwells" key preserved from the reference API
    return {"dwells": win.full_widths, "trimmean": win.means(st, en)}


def compute_trimmean_trimsd(sig, seq_to_sig, **kwargs):
    st, en = _trims(kwargs)
    win = _BaseWindows(sig, seq_to_sig)
    tmeans = win.means(st, en)
    return {
        "dwell": win.full_widths,
        "trimmean": tmeans,
        "trimsd": win.stdevs(tmeans, st, en),
    }


METRIC_FUNCS = {
    "dwell": compute_dwell,
    "dwell_mean": compute_dwell_mean,
    "dwell_mean_sd": compute_dwell_mean_sd,
    "dwell_trimmean": compute_trimmean,
    "dwell_trimmean_trimsd": compute_trimmean_trimsd,
}
