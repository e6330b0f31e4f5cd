"""Signal re-scaling estimators (least-squares and Theil–Sen); copy of
``remora_tpu/refine/rescale.py``.

Reference analog ``src/remora/refine_signal_map.py:54–121``. Every
estimator fits an affine map ``y ~ b0 + b1 * x`` between normalized
signal observations and expected k-mer expected, then folds that fit back
into the (shift, scale) pair of the ``norm = (raw - shift) / scale``
convention. Floating-point op order is kept identical to the reference
so refined DP paths stay bit-exact.
"""

import numpy as np

from remora_tpu_torch import RemoraError
from remora_tpu_torch.constants import MAX_POINTS_FOR_THEIL_SEN


def _normalize(raw, shift, scale):
    return (raw - shift) / scale


def _lstsq_refit(x, y, shift, scale):
    """Least-squares affine fit folded into updated (shift, scale)."""
    design = np.column_stack([np.ones_like(x), x])
    b0, b1 = np.linalg.lstsq(design, y, rcond=None)[0]
    if b1 == 0:
        # degenerate fit: leave scaling untouched
        return shift, scale
    return shift - (scale * b0 / b1), scale / b1


def _theil_sen_refit(x, y, shift, scale):
    """Median-of-pairwise-slopes affine fit folded into (shift, scale)."""
    from remora_tpu_torch.io.native import theil_sen_slope

    slope = theil_sen_slope(x, y)
    if slope is None:
        # native library unavailable: full pairwise slope matrix
        dx = x[:, np.newaxis] - x
        dy = y[:, np.newaxis] - y
        slope = np.median(dy[dx > 0] / dx[dx > 0])
    if slope == 0:
        raise RemoraError(
            "Read failed sequence-based signal re-scaling parameter estimation."
        )
    inter = np.median(y - (slope * x))
    return shift + (-inter / slope * scale), scale * (1 / slope)


def point_lstsq_rescale(raw, expected, shift, scale):
    return _lstsq_refit(_normalize(raw, shift, scale), expected, shift, scale)


def point_theil_sen_rescale(raw, expected, shift, scale):
    x = _normalize(raw, shift, scale)
    y = expected
    if y.shape[0] > MAX_POINTS_FOR_THEIL_SEN:
        # bound the O(n^2) pairwise-slope cost (reference RNG semantics)
        keep = np.random.choice(
            y.shape[0], MAX_POINTS_FOR_THEIL_SEN, replace=False
        )
        x, y = x[keep], y[keep]
    return _theil_sen_refit(x, y, shift, scale)


def _matched_quantiles(raw, expected, shift, scale, quants):
    """Matched (signal, level) quantile pairs for robust rough fitting."""
    x_q = np.quantile(_normalize(raw, shift, scale), quants)
    y_q = np.quantile(expected, quants)
    return x_q, y_q


def quantile_lstsq_rescale(raw, expected, shift, scale, quants):
    x, y = _matched_quantiles(raw, expected, shift, scale, quants)
    return _lstsq_refit(x, y, shift, scale)


def quantile_theil_sen_rescale(raw, expected, shift, scale, quants):
    x, y = _matched_quantiles(raw, expected, shift, scale, quants)
    return _theil_sen_refit(x, y, shift, scale)
