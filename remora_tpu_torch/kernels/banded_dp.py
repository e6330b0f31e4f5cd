"""Banded refinement DP as Hopper kernels: the forward pass (K4) and the
traceback (K5).

Counterpart of ``remora_tpu/kernels/pallas_dp.py`` (``_forward_kernel``
and ``_traceback_kernel``, launched by ``_dp_jit``) and of
``pad_reads_for_dp`` in ``remora_tpu/kernels/refine_dp.py``:

  * ``dp_forward`` (K4, ``csrc/banded_dp.cu``) runs the whole base loop of
    a batch of reads in one launch and writes one int16 traceback row per
    base, tb (R, N, W);
  * ``dp_traceback`` (K5, same source) walks those rows back from each
    read's signal end and writes the int32 paths (R, N + 1);
  * ``banded_dp_batch`` is the contract of ``banded_dp_batch_pallas`` and
    ``refine_batch`` that of ``refine_batch_pallas``.

Each kernel launches for CUDA tensors and takes its plain version
(``dp_forward_reference``, ``dp_traceback_reference``: torch ops,
vectorised over reads, with Python loops over bases and, for the stay
folds, over rows, so the float association is the kernels') only for CPU
tensors. There is no fallback: on a CUDA device a failed build, a refused
launch, a band wider than ``REFINE_DEVICE_MAX_BAND`` or inputs the kernel
does not take raise ``RemoraError``.

Paths are bit-identical to the native C++ DP (``io/native.py``), the NumPy
DP (``refine/dp.py``) and the JAX package's Pallas kernels.
"""

import ctypes

import numpy as np
import torch

from remora_tpu_torch import RemoraError
from remora_tpu_torch.constants import (
    REFINE_ALGO_DWELL_PEN_NAME,
    REFINE_ALGO_VIT_NAME,
    REFINE_DEVICE_MAX_BAND,
)
from remora_tpu_torch.core.util import resolve_device
from remora_tpu_torch.kernels import _build

# kernel launches in this process: K4 (one per ``dp_forward`` on CUDA) and
# K5 (one per ``dp_traceback`` on CUDA)
LAUNCHES_FWD = 0
LAUNCHES_TB = 0

LARGE_SCORE = 100.0
BIG = 3.0e38


def launch_width(w_max):
    """The traceback row width of a launch: ``w_max`` rounded up to 8, as
    the Pallas kernel pads it."""
    return int(np.ceil(max(int(w_max), 8) / 8)) * 8


# ---------------- plain versions ----------------


def _shift_down(x, k, fill):
    """x[:, p] = x_in[:, p - k] (columns < k filled)."""
    if k == 0:
        return x
    pad = torch.full_like(x[:, :k], fill)
    return torch.cat([pad, x[:, :-k]], dim=1)


def _stay_fold(base, cand, ctb, n_rows, p0c=None):
    """Exact sequential stay fold over rows 0 .. n_rows-1 of (R, W)
    tensors: stay = carry + base; the candidate is taken on strict
    improvement, or below the per-read row ``p0c`` unconditionally.
    Returns (scores, codes) for those rows."""
    R = base.shape[0]
    cs = torch.full((R,), float("inf"), dtype=torch.float32,
                    device=base.device)
    ct = torch.zeros((R,), dtype=torch.int32, device=base.device)
    scores, codes = [], []
    for i in range(n_rows):
        stay = cs + base[:, i]
        take = cand[:, i] < stay if p0c is None else i < p0c
        cs = torch.where(take, cand[:, i], stay)
        ct = torch.where(take, ctb[:, i], ct + 1)
        scores.append(cs)
        codes.append(ct)
    return torch.stack(scores, 1), torch.stack(codes, 1)


def _pad_cols(x, W, fill):
    if x.shape[1] == W:
        return x
    return torch.cat([x, torch.full_like(x[:, :1], fill).expand(
        -1, W - x.shape[1])], dim=1)


def dp_forward_reference(signal, levels, starts, widths, sdp, dwell, W):
    """Plain version of K4: tb (R, N, W) int16 from signal (R, S) f32,
    levels (R, N) f32, band starts and widths (R, N) int32 and the
    short-dwell penalties sdp (L,) f32. Each base folds only to the widest
    band among the reads (rows past a read's own width do not move its
    rows below it); tb rows past a read's width hold 0."""
    R, N = levels.shape
    S = signal.shape[1]
    dev = signal.device
    L = int(sdp.shape[0])
    sig_pad = torch.cat(
        [signal, torch.zeros((R, W), dtype=signal.dtype, device=dev)], 1
    )
    rows = torch.arange(W, device=dev)
    ridx = torch.arange(R, device=dev)
    prev = torch.full((R, W), BIG, dtype=torch.float32, device=dev)
    prev[:, 0] = 0.0
    prev_start = starts[:, 0] - 1
    prev_valid = widths[:, 0]
    tb = torch.zeros((R, N, W), dtype=torch.int16, device=dev)
    for n in range(N):
        st, w = starts[:, n], widths[:, n]
        bsd = st - prev_start
        in_band = rows < w[:, None]
        cols = (st[:, None] + rows).clamp(0, S + W - 1)
        diff = torch.gather(sig_pad, 1, cols) - levels[:, n, None]
        base = torch.where(in_band, diff * diff, 0.0)
        prev_last = prev[ridx, prev_valid - 1]
        src = rows - 1 + bsd[:, None]
        src_ok = (src >= 0) & (src < prev_valid[:, None])
        prev_g = torch.gather(prev, 1, src.clamp(0, W - 1))
        mv = torch.where(src_ok, prev_g + base, BIG)
        at_entry = (rows == 0) & (bsd == 0)[:, None]
        mv = torch.where(at_entry, (LARGE_SCORE + prev_last)[:, None], mv)
        move_limit = torch.minimum(prev_valid - bsd, w - 1)
        mv = torch.where((rows <= move_limit[:, None]) | (rows == 0), mv, BIG)
        mv = torch.where(in_band, mv, BIG)
        mv_tb = at_entry.to(torch.int32) * -1
        n_rows = int(w.max())
        if dwell:
            unpen, unpen_tb = _stay_fold(base, mv, mv_tb, n_rows)
            unpen = _pad_cols(unpen, W, BIG)
            unpen_tb = _pad_cols(unpen_tb, W, 0)
            invalid = LARGE_SCORE + prev_last
            curr = invalid[:, None].expand(R, W).clone()
            ctb = torch.full((R, W), -1, dtype=torch.int32, device=dev)
            p0 = prev_valid - bsd + L
            main = rows < p0[:, None]
            run = base
            for d in range(L):
                if d > 0:
                    run = run + _shift_down(base, d, 0.0)
                prev_idx = rows - d - 1 + bsd[:, None]
                valid = (
                    main & in_band & (rows >= d)
                    & ~((bsd == 0)[:, None] & (rows == d))
                    & ~at_entry
                    & (prev_idx >= 0) & (prev_idx < prev_valid[:, None])
                )
                prev_gd = torch.gather(prev, 1, prev_idx.clamp(0, W - 1))
                cand = prev_gd + run + sdp[d]
                upd = valid & (cand < curr)
                curr = torch.where(upd, cand, curr)
                ctb = torch.where(upd, d, ctb)
            long_ok = main & in_band & (rows >= L)
            cand = _shift_down(unpen, L, BIG) + run
            upd = long_ok & (cand < curr)
            curr = torch.where(upd, cand, curr)
            ctb = torch.where(upd, _shift_down(unpen_tb, L, 0) + L, ctb)
            scores, codes = _stay_fold(
                base, curr, ctb, n_rows, p0c=torch.clamp(p0, min=1)
            )
        else:
            scores, codes = _stay_fold(base, mv, mv_tb, n_rows)
        scores = _pad_cols(scores, W, BIG)
        codes = _pad_cols(codes, W, 0)
        prev = torch.where(in_band, scores, BIG)
        tb[:, n] = torch.where(in_band, codes, 0).to(torch.int16)
        prev_start, prev_valid = st, w
    return tb


def dp_traceback_reference(tb, starts, widths, seq_lens):
    """Plain version of K5: paths (R, N + 1) int32 from tb (R, N, W); path[0]
    = 0, path[i] = the read's signal end for i >= seq_len (clamped to 1 ..
    N). Int32 arithmetic wraps, as the kernel's does."""
    R, N, W = tb.shape
    dev = tb.device
    ridx = torch.arange(R, device=dev)
    sl = seq_lens.clamp(1, N).long()
    sig_end = starts[ridx, sl - 1] + widths[ridx, sl - 1]
    path = torch.zeros((R, N + 1), dtype=torch.int32, device=dev)
    path[:, N] = sig_end
    nxt = sig_end
    for i in range(N - 1, 0, -1):
        lookup = nxt - 1
        off = (lookup - starts[:, i]).clamp(0, W - 1)
        step = tb[ridx, i, off].to(torch.int32)
        nxt = torch.where(i <= sl - 1, lookup - step, nxt)
        path[:, i] = nxt
    return path


# ---------------- the kernels ----------------


def _library():
    lib = _build.load("banded_dp")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.banded_dp_forward.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32,
                                          i32, i32, i32, i32, ptr, ptr]
        lib.banded_dp_forward.restype = i32
        lib.banded_dp_traceback.argtypes = [ptr, ptr, ptr, ptr, i32, i32,
                                            i32, ptr, ptr]
        lib.banded_dp_traceback.restype = i32
        lib.banded_dp_max_dwell.argtypes = []
        lib.banded_dp_max_dwell.restype = i32
        lib.banded_dp_error_string.argtypes = [i32]
        lib.banded_dp_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _checked(name, t, dtype, shape, device):
    if t.device != device:
        raise RemoraError(f"{name} is on {t.device}, not {device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            not t.is_contiguous():
        raise RemoraError(
            f"{name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)}; got {t.dtype} {tuple(t.shape)}"
        )


def _cuda_device(x, kernel):
    if x.device.type != "cuda":
        raise RemoraError(f"{kernel}: no kernel for device {x.device}")
    return x.device


def _load_library(kernel):
    try:
        return _library()
    except RemoraError:
        raise
    except Exception as err:
        raise RemoraError(f"{kernel}: the CUDA library failed to load ({err})")


def _raise_launch(lib, kernel, err):
    raise RemoraError(
        f"{kernel} kernel launch failed: "
        f"{lib.banded_dp_error_string(err).decode()} (cudaError {err})"
    )


def dp_forward(signal, levels, starts, widths, sdp, dwell, W):
    """K4: traceback rows tb (R, N, W) int16 of the banded DP (Viterbi, or
    dwell_penalty when ``dwell``) for signal (R, S) f32, levels (R, N) f32,
    band starts and widths (R, N) int32 (every width in 1 .. W) and the
    short-dwell penalties sdp (L,) f32. tb is the plain version's bit for
    bit on any input, a NaN signal sample or level included (the native
    host DP's paths agree with both on finite inputs only)."""
    global LAUNCHES_FWD
    if signal.device.type == "cpu":
        return dp_forward_reference(signal, levels, starts, widths, sdp,
                                    dwell, W)
    device = _cuda_device(signal, "dp_forward")
    R, N = levels.shape
    _checked("signal", signal, torch.float32, (R, signal.shape[1]), device)
    _checked("levels", levels, torch.float32, (R, N), device)
    _checked("starts", starts, torch.int32, (R, N), device)
    _checked("widths", widths, torch.int32, (R, N), device)
    _checked("sdp", sdp, torch.float32, (sdp.shape[0],), device)
    if W > REFINE_DEVICE_MAX_BAND:
        raise RemoraError(
            f"dp_forward: band width {W} exceeds the device DP limit "
            f"({REFINE_DEVICE_MAX_BAND})"
        )
    lib = _load_library("dp_forward")
    if sdp.shape[0] > lib.banded_dp_max_dwell():
        raise RemoraError(
            f"dp_forward: {sdp.shape[0]} short-dwell penalties; the kernel "
            f"takes at most {lib.banded_dp_max_dwell()}"
        )
    tb = torch.empty((R, N, W), dtype=torch.int16, device=device)
    with torch.cuda.device(device):
        err = lib.banded_dp_forward(
            signal.data_ptr(), levels.data_ptr(), starts.data_ptr(),
            widths.data_ptr(), sdp.data_ptr(), int(sdp.shape[0]),
            int(bool(dwell)), R, N, int(signal.shape[1]), W, tb.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        _raise_launch(lib, "dp_forward", err)
    LAUNCHES_FWD += 1
    return tb


def dp_traceback(tb, starts, widths, seq_lens):
    """K5: paths (R, N + 1) int32 from the traceback rows tb (R, N, W)
    int16, band starts and widths (R, N) int32 and seq_lens (R,) int32
    (each in 1 .. N). On CUDA the kernel copies whole rows by TMA, so tb
    must start on a 16-byte boundary and W be a multiple of 8 (rows of a
    multiple of 16 bytes, as ``launch_width`` makes them); anything else
    raises."""
    global LAUNCHES_TB
    if tb.device.type == "cpu":
        return dp_traceback_reference(tb, starts, widths, seq_lens)
    device = _cuda_device(tb, "dp_traceback")
    R, N, W = tb.shape
    _checked("tb", tb, torch.int16, (R, N, W), device)
    _checked("starts", starts, torch.int32, (R, N), device)
    _checked("widths", widths, torch.int32, (R, N), device)
    _checked("seq_lens", seq_lens, torch.int32, (R,), device)
    if tb.data_ptr() % 16 != 0:
        raise RemoraError(
            "dp_traceback: tb must start on a 16-byte boundary (the kernel "
            f"copies its rows by TMA); its data pointer is "
            f"{tb.data_ptr() % 16} bytes past one"
        )
    if N < 1 or W % 8 != 0 or W > REFINE_DEVICE_MAX_BAND:
        raise RemoraError(
            f"dp_traceback: tb of {N} bases and rows of W = {W}; the kernel "
            f"takes N >= 1 and W a multiple of 8 up to "
            f"{REFINE_DEVICE_MAX_BAND}"
        )
    lib = _load_library("dp_traceback")
    path = torch.empty((R, N + 1), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.banded_dp_traceback(
            tb.data_ptr(), starts.data_ptr(), widths.data_ptr(),
            seq_lens.data_ptr(), R, N, W, path.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        _raise_launch(lib, "dp_traceback", err)
    LAUNCHES_TB += 1
    return path


# ---------------- batch entry points ----------------


_NUMPY_DTYPES = {torch.float32: np.float32, torch.int32: np.int32}


def _check_bands(band_widths, seq_lens, W):
    """Every band width in 1 .. W and every seq_len in 1 .. N, checked on
    the host (the refiner hands its bands over as numpy arrays)."""
    widths = np.asarray(torch.as_tensor(band_widths).cpu())
    lens = np.asarray(torch.as_tensor(seq_lens).cpu())
    if widths.size and (widths.min() < 1 or widths.max() > W):
        raise RemoraError(
            f"band widths must lie in 1 .. {W} (the launch width); got "
            f"{widths.min()} .. {widths.max()}"
        )
    if lens.size and (lens.min() < 1 or lens.max() > widths.shape[-1]):
        raise RemoraError(
            f"seq_lens must lie in 1 .. {widths.shape[-1]}; got "
            f"{lens.min()} .. {lens.max()}"
        )


def _as_tensor(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    arr = np.ascontiguousarray(x, dtype=_NUMPY_DTYPES[dtype])
    return torch.from_numpy(arr).to(device)


def banded_dp_batch(signal, levels, band_starts, band_widths, seq_lens, sdp,
                    algo=REFINE_ALGO_DWELL_PEN_NAME, w_max=16, device=None):
    """Forward + traceback for a batch of reads, one launch each (the
    contract of ``banded_dp_batch_pallas``).

    Inputs are arrays or tensors: signal (R, S), levels (R, N), band starts
    and widths (R, N), seq_lens (R,), sdp (L,). They run on ``device``
    (default: the device of a ``signal`` tensor, else the GPU). Returns
    (path (R, N + 1) int32, traceback (R, N, W) int16, None)."""
    if algo not in (REFINE_ALGO_DWELL_PEN_NAME, REFINE_ALGO_VIT_NAME):
        raise RemoraError(f"Invalid core signal mapping refine method: {algo}")
    if device is None and isinstance(signal, torch.Tensor):
        device = signal.device
    device = resolve_device(device)
    W = launch_width(w_max)
    _check_bands(band_widths, seq_lens, W)
    signal = _as_tensor(signal, torch.float32, device)
    levels = _as_tensor(levels, torch.float32, device)
    starts = _as_tensor(band_starts, torch.int32, device)
    widths = _as_tensor(band_widths, torch.int32, device)
    seq_lens = _as_tensor(seq_lens, torch.int32, device)
    sdp = _as_tensor(sdp, torch.float32, device)
    tb = dp_forward(signal, levels, starts, widths, sdp,
                    algo == REFINE_ALGO_DWELL_PEN_NAME, W)
    path = dp_traceback(tb, starts, widths, seq_lens)
    return path, tb, None


def pad_reads_for_dp(reads, w_max=None):
    """Pack a list of (signal, levels, seq_band) into batch arrays (copy of
    ``remora_tpu/kernels/refine_dp.py::pad_reads_for_dp``).

    Returns dict of arrays + (n_max, s_max, w_max) shapes used.
    """
    R = len(reads)
    n_max = max(lv.size for _sig, lv, _bd in reads)
    s_max = max(sig.size for sig, _lv, _bd in reads)
    widths = [int((bd[1] - bd[0]).max()) for _sig, _lv, bd in reads]
    if w_max is None:
        w_max = max(widths)
    signal = np.zeros((R, s_max), np.float32)
    levels = np.zeros((R, n_max), np.float32)
    starts = np.zeros((R, n_max), np.int32)
    bwidths = np.ones((R, n_max), np.int32)
    seq_lens = np.zeros(R, np.int32)
    for r, (sig, lv, bd) in enumerate(reads):
        n = lv.size
        signal[r, : sig.size] = sig
        levels[r, :n] = lv
        starts[r, :n] = bd[0]
        bwidths[r, :n] = bd[1] - bd[0]
        # padding rows: keep band anchored at the end with width 1
        if n < n_max:
            starts[r, n:] = bd[1][-1] - 1
            bwidths[r, n:] = 1
        seq_lens[r] = n
    return {
        "signal": signal,
        "levels": levels,
        "band_starts": starts,
        "band_widths": bwidths,
        "seq_lens": seq_lens,
        "w_max": int(w_max),
    }


def refine_batch(reads, sdp, algo=REFINE_ALGO_DWELL_PEN_NAME, w_max=None,
                 device=None):
    """Host API: list of (norm_signal, levels, seq_band) -> list of int32
    paths (seq_len + 1 each), via K4 and K5 (the contract of
    ``refine_batch_pallas``)."""
    packed = pad_reads_for_dp(reads, w_max=w_max)
    path, _tb, _ = banded_dp_batch(
        packed["signal"],
        packed["levels"],
        packed["band_starts"],
        packed["band_widths"],
        packed["seq_lens"],
        np.asarray(sdp, np.float32),
        algo=algo,
        w_max=packed["w_max"],
        device=device,
    )
    path = path.cpu().numpy()
    return [
        path[r, : packed["seq_lens"][r] + 1] for r in range(len(reads))
    ]
