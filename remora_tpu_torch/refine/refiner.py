"""Signal-mapping refiner: k-mer level scaling + banded-DP runner.

Port of ``remora_tpu/refine/refiner.py`` (reference analog:
``SigMapRefiner``, ``src/remora/refine_signal_map.py:150–626``, and
``refine_signal_mapping``, ``:778–840``). Serialization keys and float op
order follow the JAX package, so datasets, model metadata and refined DP
paths are bit-compatible with it. The device backend runs the banded DP
as the CUDA kernels K4/K5 (``kernels/banded_dp.py``) on ``device`` (the
GPU unless ``device="cpu"`` is named; the plain versions run on the CPU).

One deliberate difference from the JAX package: ``refine_reads_batch``
there reroutes the whole batch to the host DP when the device loop raises
anything, which would hide a kernel that fails to build or launch. Here
only the two pre-launch guards reroute (a band wider than
``REFINE_DEVICE_MAX_BAND``, a traceback tensor over its budget); they
raise ``DeviceDPRouteError`` and the batch restarts on the host from the
post-rough-rescale shift and scale. Every other exception propagates.
"""

import os
from dataclasses import dataclass, field
from itertools import islice
from typing import Optional

import numpy as np

from remora_tpu_torch import RemoraError, log
from remora_tpu_torch.constants import (
    DEFAULT_REFINE_ALGO,
    DEFAULT_REFINE_HBW,
    DEFAULT_REFINE_SHORT_DWELL_PARAMS,
    DEFAULT_ROUGH_RESCALE_METHOD,
    REFINE_ALGO_DWELL_PEN_NAME,
    REFINE_BACKEND_AUTO,
    REFINE_BACKEND_DEVICE,
    REFINE_BACKEND_NATIVE,
    REFINE_BACKEND_NUMPY,
    REFINE_BACKENDS,
    REFINE_DEVICE_MAX_BAND,
    ROUGH_RESCALE_LEAST_SQUARES,
    ROUGH_RESCALE_METHODS,
    ROUGH_RESCALE_THEIL_SEN,
)
from remora_tpu_torch.core.util import resolve_device
from remora_tpu_torch.refine import band as band_mod
from remora_tpu_torch.refine import dp as dp_mod
from remora_tpu_torch.refine import levels as levels_mod
from remora_tpu_torch.refine import rescale as rescale_mod

LOGGER = log.get_logger()

# what the device DP did in this process: the K4/K5 launches it planned
# (one forward and one traceback each; the batched stage's and the
# single-read path's) and the reads the batched stage routed to the host
# DP instead (per-read routing and DeviceDPRouteError reroutes)
PLANNED_LAUNCHES = 0
HOST_ROUTED_READS = 0


class DeviceDPRouteError(RemoraError):
    """A read batch the device DP must not take (a band wider than
    ``REFINE_DEVICE_MAX_BAND``, a traceback tensor over its budget),
    raised before any launch; ``refine_reads_batch`` reroutes it to the
    host DP."""


def compute_dwell_pen_array(target: int, limit: int, weight: float):
    """Quadratic short-dwell penalty table: weight * (d - target)^2."""
    if limit > target:
        LOGGER.warning(
            f"Short-dwell limit ({limit}) exceeds the target dwell "
            f"({target}); clamping limit to the target."
        )
        limit = target
    dwell_axis = np.arange(limit, dtype=np.float32)
    return weight * np.square(dwell_axis - target)


DEFAULT_REFINE_SHORT_DWELL_PEN = compute_dwell_pen_array(
    *DEFAULT_REFINE_SHORT_DWELL_PARAMS
)


def _default_sd_pen():
    return DEFAULT_REFINE_SHORT_DWELL_PEN

_ROUGH_RESCALE_DISPATCH = {
    ROUGH_RESCALE_LEAST_SQUARES: rescale_mod.quantile_lstsq_rescale,
    ROUGH_RESCALE_THEIL_SEN: rescale_mod.quantile_theil_sen_rescale,
}


# reads per DP launch (the JAX package's 128-lane read tile); bucket
# launches are chunked to this many reads, so the budget math below bounds
# every launch's (R, N, W) traceback tensor
_DP_LAUNCH_LANES = 128


def _dp_tb_bytes(n_bases, w_read):
    """Estimated device traceback-tensor footprint of a device-DP launch
    carrying this read: bases padded to 256, width to its pow-2 bucket,
    128 reads, int16 (the JAX package's model, kept so the routing is
    its routing; the port's (R, N, W) tensor of a launch of at most 128
    reads is no larger)."""
    n_pad = -(-max(int(n_bases), 1) // 256) * 256
    w_pad = 1 << (max(int(w_read), 16) - 1).bit_length()
    return n_pad * w_pad * _DP_LAUNCH_LANES * 2


def _dp_tb_budget_bytes():
    """Per-launch device-memory budget for the DP traceback tensor.

    REMORA_TPU_DP_TB_BUDGET_MB overrides (default 4096 MB, as in the JAX
    package). Reads whose tensor would exceed it route to the host DP;
    an unparseable override fails fast (same contract as
    REMORA_TPU_REFINE_DP) rather than silently degrading."""
    raw = os.environ.get("REMORA_TPU_DP_TB_BUDGET_MB", "4096")
    try:
        return int(raw) * (1024 * 1024)
    except ValueError:
        raise RemoraError(
            f"REMORA_TPU_DP_TB_BUDGET_MB={raw!r} is not an integer"
        )


def _refine_dp_devices(device):
    """Devices the device-DP refine stage spreads over: every visible GPU
    for ``cuda`` without an index (``torch.cuda.device_count()``), else
    ``device`` alone.

    REMORA_TPU_REFINE_DP overrides the count (0/1 = single device);
    invalid values fail fast with RemoraError rather than silently
    degrading to the host path."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [device]
    n_req = os.environ.get("REMORA_TPU_REFINE_DP")
    if n_req is None:
        return devs
    try:
        n = int(n_req)
    except ValueError:
        raise RemoraError(
            f"REMORA_TPU_REFINE_DP={n_req!r} is not an integer"
        )
    if n > len(devs):
        raise RemoraError(
            f"REMORA_TPU_REFINE_DP={n} but only {len(devs)} local "
            "devices are attached"
        )
    return devs[: max(1, n)]


def _banded_search_space(seq_to_sig_map, levels, sig_len, bhw, min_step):
    """Per-base [lower, upper) signal bounds for the banded DP."""
    sig_band = band_mod.compute_sig_band(seq_to_sig_map, levels, bhw=bhw)
    seq_band = band_mod.convert_to_seq_band(sig_band)
    band_mod.adjust_seq_band(seq_band, min_step=min_step)
    band_mod.validate_band(
        seq_band, is_sig_band=False, seq_len=levels.shape[0], sig_len=sig_len
    )
    return seq_band


def _device_dp_paths(read_tuples, short_dwell_pen, refine_algo, device):
    """Batched banded DP on ``device`` (K4/K5): list of
    (norm_signal_f32, levels_f32, seq_band) -> list of int32 paths."""
    from remora_tpu_torch.kernels.banded_dp import refine_batch

    return refine_batch(
        read_tuples, short_dwell_pen, algo=refine_algo, device=device
    )


def refine_signal_mapping(
    signal,
    seq_to_sig_map,
    levels,
    *,
    refine_algo=DEFAULT_REFINE_ALGO,
    short_dwell_pen=DEFAULT_REFINE_SHORT_DWELL_PEN,
    band_half_width=DEFAULT_REFINE_HBW,
    adjust_band_min_step=2,
    backend=REFINE_BACKEND_AUTO,
    device=None,
):
    """Refine one read's signal mapping against expected levels.

    Returns (path + sig offset, all_scores, traceback, seq_band,
    base_offsets); score/traceback entries are None except on the NumPy
    path (the native/device fast paths return the path only).

    ``backend`` routes the DP: ``auto`` takes the native C++ core when
    built (falling back to NumPy), ``native``/``numpy`` force those, and
    ``device`` runs the CUDA kernels K4/K5 on ``device`` (the GPU unless
    named; a batch of one here — ``SigMapRefiner.refine_reads_batch`` is
    the batched entry point that amortizes launches/transfers across
    reads).
    """
    global PLANNED_LAUNCHES
    # rebase everything so base 0 starts at signal index 0
    origin = int(seq_to_sig_map[0])
    signal = signal[origin : seq_to_sig_map[-1]]
    if origin:
        seq_to_sig_map = seq_to_sig_map - origin

    seq_band = _banded_search_space(
        seq_to_sig_map,
        levels,
        signal.shape[0],
        band_half_width,
        adjust_band_min_step,
    )
    sig_f32 = signal.astype(np.float32)
    lvl_f32 = np.nan_to_num(levels, nan=0.0).astype(np.float32)

    if backend == REFINE_BACKEND_DEVICE:
        PLANNED_LAUNCHES += 1
        (path,) = _device_dp_paths(
            [(sig_f32, lvl_f32, seq_band)], short_dwell_pen, refine_algo,
            device,
        )
        return path + origin, None, None, seq_band, None
    if backend != REFINE_BACKEND_NUMPY:
        # native C++ DP when available (same semantics, ~70x NumPy)
        from remora_tpu_torch.io.native import banded_dp_path

        path = banded_dp_path(
            sig_f32, lvl_f32, seq_band, short_dwell_pen, refine_algo
        )
        if path is not None:
            return path + origin, None, None, seq_band, None
        if backend == REFINE_BACKEND_NATIVE:
            raise RemoraError(
                "refine backend 'native' requested but the native DP "
                "core is unavailable (csrc build failed?)"
            )
    all_scores, path, traceback, base_offsets = dp_mod.seq_banded_dp(
        sig_f32, lvl_f32, seq_band, short_dwell_pen, refine_algo
    )
    return path + origin, all_scores, traceback, seq_band, base_offsets


@dataclass
class SigMapRefiner:
    """K-mer level table manager, re-scaler, and refinement runner."""

    # level-table source (one of: file, string dict, raw array below)
    kmer_model_filename: Optional["str"] = None
    # scaling behavior
    do_rough_rescale: "bool" = False
    scale_iters: "int" = -1
    rough_rescale_method: "str" = DEFAULT_ROUGH_RESCALE_METHOD
    # DP settings
    algo: "str" = DEFAULT_REFINE_ALGO
    half_bandwidth: "int" = DEFAULT_REFINE_HBW
    sd_params: Optional[tuple] = None
    # DP execution backend — a runtime routing choice (auto/native/
    # numpy/device); NOT serialized with dataset/model metadata and
    # excluded from __eq__, since it cannot change results
    backend: "str" = REFINE_BACKEND_AUTO
    # torch device of the device DP, also runtime only (not serialized,
    # not in __eq__): the GPU unless named; resolved for backend "device"
    device: Optional[object] = None
    do_fix_guage: "bool" = False
    sd_arr: np.ndarray = field(default_factory=lambda: _default_sd_pen())
    # loaded/derived state
    _levels_array: Optional[np.ndarray] = None
    str_kmer_levels: Optional[dict] = None
    kmer_len: Optional["int"] = None
    kmer_idx_stats: Optional[list] = None
    center_idx: "int" = -1
    is_loaded: "bool" = False

    def __post_init__(self):
        self._ingest_levels()
        wants_scaling = self.do_rough_rescale or self.scale_iters >= 0
        if wants_scaling and not self.is_loaded:
            raise RemoraError(
                "Signal re-scaling requested but no levels table is loaded "
                f"(is_loaded={self.is_loaded}, "
                f"do_rough_rescale={self.do_rough_rescale}, "
                f"scale_iters={self.scale_iters})"
            )
        if self.sd_params is not None:
            target, limit, weight = self.sd_params
            self.sd_arr = compute_dwell_pen_array(target, limit, weight)
        if self.is_loaded and not wants_scaling:
            LOGGER.warning(
                "A k-mer table was supplied but neither rough re-scaling "
                "nor refinement is enabled, so it will go unused."
            )
        if self.rough_rescale_method not in ROUGH_RESCALE_METHODS:
            known = ", ".join(ROUGH_RESCALE_METHODS)
            raise RemoraError(
                f"rough_rescale_method {self.rough_rescale_method!r} "
                f"not one of: {known}"
            )
        if self.backend not in REFINE_BACKENDS:
            known = ", ".join(REFINE_BACKENDS)
            raise RemoraError(
                f"refine backend {self.backend!r} not one of: {known}"
            )
        if self.backend == REFINE_BACKEND_DEVICE:
            self.device = resolve_device(self.device)

    @property
    def dp_device(self):
        """The torch device of the device DP (raises without a GPU when
        no device was named)."""
        return resolve_device(self.device)

    def _ingest_levels(self):
        """Populate level state from whichever source was provided."""
        arr = self._levels_array
        if arr is not None and np.asarray(arr).dtype != object:
            # a (possibly legacy-pickled) 4^k level table
            self.is_loaded = True
            self.kmer_len = (arr.size - 1).bit_length() // 2
            assert 4**self.kmer_len == arr.size
            return
        if self.kmer_model_filename is not None:
            self.str_kmer_levels, self.kmer_len = levels_mod.load_kmer_table(
                self.kmer_model_filename
            )
        if self.str_kmer_levels is None:
            return
        self.is_loaded = True
        self._determine_dominant_pos()
        if self.do_fix_guage:
            self.fix_gauge()

    def __repr__(self):
        if self.is_loaded is False:
            return "No remora_tpu signal refine/map settings loaded"
        parts = [
            f"{self.kmer_len}-mer level table loaded "
            f"(central position {self.center_idx + 1})."
        ]
        if self.do_rough_rescale:
            parts.append("Rough re-scaling enabled.")
        if self.scale_iters > 0:
            parts.append(
                f"{self.scale_iters} refine-then-rescale iterations enabled."
            )
        if self.scale_iters >= 0:
            parts.append(
                f"Signal-mapping refinement enabled (algo: {self.algo}, "
                f"band half width {self.half_bandwidth})."
            )
            if self.algo == REFINE_ALGO_DWELL_PEN_NAME:
                parts.append(f"Short-dwell penalties: {self.sd_arr}.")
        return " ".join(parts)

    @property
    def bases_before(self):
        return self.center_idx

    @property
    def bases_after(self):
        return self.kmer_len - 1 - self.center_idx

    @property
    def is_valid(self):
        wants_scaling = self.do_rough_rescale or self.scale_iters >= 0
        return wants_scaling if self.is_loaded else not wants_scaling

    def _determine_dominant_pos(self):
        if self.str_kmer_levels is None:
            return
        self.center_idx, self.kmer_idx_stats = (
            levels_mod.determine_dominant_pos(
                self.str_kmer_levels, self.kmer_len
            )
        )

    @property
    def levels_array(self):
        if self._levels_array is not None or self.str_kmer_levels is None:
            return self._levels_array
        self._levels_array = levels_mod.levels_dict_to_array(
            self.str_kmer_levels, self.kmer_len
        )
        return self._levels_array

    @property
    def kmers(self):
        yield from levels_mod.all_kmers(self.kmer_len)

    def write_kmer_table(self, fh):
        for idx, kmer in enumerate(self.kmers):
            fh.write(f"{kmer}\t{self.levels_array[idx]}\n")

    def fix_gauge(self):
        self._levels_array = levels_mod.fix_gauge(self.levels_array)
        self.str_kmer_levels = dict(zip(self.kmers, self._levels_array))

    def extract_levels(self, int_seq):
        return levels_mod.extract_levels(
            int_seq, self.levels_array, self.kmer_len, self.center_idx
        )

    def rough_rescale(
        self,
        shift,
        scale,
        seq_to_sig_map,
        int_seq,
        dacs,
        *,
        use_base_center=True,
        clip_bases=10,
        quants=None,
    ):
        """Quantile-based rescale of (shift, scale) against expected levels."""
        if quants is None:
            quants = np.arange(0.05, 1, 0.05)
        levels = self.extract_levels(int_seq)
        if use_base_center:
            # one representative DAC per base: the mid-dwell sample
            starts = seq_to_sig_map[:-1]
            mid_dwell = starts + (seq_to_sig_map[1:] - starts) // 2
            fit_dacs = dacs[mid_dwell]
            if 0 < clip_bases < levels.size / 2:
                interior = slice(clip_bases, -clip_bases)
                levels, fit_dacs = levels[interior], fit_dacs[interior]
        else:
            span = slice(seq_to_sig_map[0], seq_to_sig_map[-1])
            fit_dacs = dacs[span]
        try:
            estimator = _ROUGH_RESCALE_DISPATCH[self.rough_rescale_method]
        except KeyError:
            raise RemoraError(
                f"No such rough re-scale estimator: "
                f"{self.rough_rescale_method}"
            )
        return estimator(fit_dacs, levels, shift, scale, quants)

    def rescale(
        self,
        levels,
        dacs,
        shift,
        scale,
        seq_to_sig_map,
        *,
        min_levels=10,
        min_abs_level=0.2,
        edge_filter_bases=10,
        dwell_filter_pctls=(10, 90),
    ):
        """Precise rescale from the current mapping with dwell/level filters."""
        spans = np.diff(seq_to_sig_map)
        with np.errstate(invalid="ignore"):
            prefix = np.empty(dacs.size + 1)
            prefix[0] = 0
            np.cumsum(dacs, out=prefix[1:])
            per_base_dac = np.diff(prefix[seq_to_sig_map]) / spans

        # drop bases in the dwell-distribution tails (poor assignments),
        # near-mean levels (no rescaling signal), and read edges
        dwell_lo, dwell_hi = np.percentile(spans, dwell_filter_pctls)
        keep = (spans > dwell_lo) & (spans < dwell_hi)
        centered_levels = levels - np.mean(levels)
        keep &= np.abs(centered_levels) > min_abs_level
        keep &= ~np.isnan(per_base_dac)
        if edge_filter_bases > 0:
            keep[:edge_filter_bases] = False
            keep[-edge_filter_bases:] = False
        if np.count_nonzero(keep) < min_levels:
            raise RemoraError("Too few positions")
        return rescale_mod.point_theil_sen_rescale(
            per_base_dac[keep], levels[keep], shift, scale
        )

    def refine_sig_map(
        self,
        shift: float,
        scale: float,
        seq_to_sig_map: np.ndarray,
        int_seq: np.ndarray,
        dacs: np.ndarray,
        backend=None,
    ):
        """scale_iters rounds of banded-DP refinement + precise rescale.

        ``backend`` overrides the refiner's routing for this call (the
        batched device path falls back here with ``backend="auto"``).
        """
        backend = self.backend if backend is None else backend
        levels = self.extract_levels(int_seq)
        origin = seq_to_sig_map[0]
        dacs = dacs[origin : seq_to_sig_map[-1]]
        seq_to_sig_map = seq_to_sig_map - origin
        rescale_each_round = self.scale_iters > 0
        for _ in range(max(self.scale_iters, 1)):
            norm_sig = (dacs - shift) / scale
            seq_to_sig_map = refine_signal_mapping(
                norm_sig,
                seq_to_sig_map,
                levels,
                refine_algo=self.algo,
                short_dwell_pen=self.sd_arr,
                band_half_width=self.half_bandwidth,
                backend=backend,
                device=self.device,
            )[0]
            if not rescale_each_round:
                continue
            try:
                shift, scale = self.rescale(
                    levels,
                    dacs,
                    shift,
                    scale,
                    seq_to_sig_map,
                )
            except RemoraError as err:
                LOGGER.debug(f"precise re-scale skipped: {err}")
                break
        return seq_to_sig_map + origin, shift, scale

    def refine_reads_batch(self, reads):
        """Batched ``RemoraRead.refine_signal_mapping`` on the device DP.

        Semantically equivalent to ``read.refine_signal_mapping(self)``
        per read (rough rescale stays on host; per-read IndexError keeps
        the original mapping, matching ``data/read.py:225–236``), but
        every scale iteration runs the banded DP for ALL reads in a few
        K4/K5 launches on ``device`` (pow-2 band-width buckets of at most
        128 reads), and each read's signal is staged to the device ONCE
        across the ``scale_iters`` loop — only the (small) band arrays
        and per-read shift/scale scalars travel per iteration.

        Returns a list (len(reads)) of per-read errors: ``None`` on
        success/no-op, otherwise the exception that the single-read path
        would have raised out of ``refine_signal_mapping`` (callers drop
        those reads, mirroring the pipeline's per-item guard).

        Reference analog: the per-read ``refine_sig_map`` loop
        (``src/remora/refine_signal_map.py:471–495``) — the reference
        has no batched form; this entry point exists so prepare/infer
        pipelines can amortize device launches/transfers across reads.

        Exactness: with a single DP round (``scale_iters <= 0``) the
        normalization is computed on host with the exact single-read
        float semantics, so paths are bit-identical to the host
        backends. With ``scale_iters > 0`` the per-round normalization
        ``(dacs - shift) / scale`` runs on device in float32 (that is
        the point of staging the signal once), as in the JAX package's
        device path (IEEE f32 subtract and divide, so the same bits);
        results can differ from the host path by DP ties on <=1-ulp
        signal differences.

        Only ``DeviceDPRouteError`` (the pre-launch guards) reroutes the
        device reads to the host DP; any other exception propagates.
        """
        global HOST_ROUTED_READS
        errs = [None] * len(reads)
        if not self.is_loaded:
            return errs
        if self.do_rough_rescale:
            for idx, rd in enumerate(reads):
                try:
                    rd.shift, rd.scale = self.rough_rescale(
                        dacs=rd.dacs,
                        int_seq=rd.int_seq,
                        seq_to_sig_map=rd.seq_to_sig_map,
                        shift=rd.shift,
                        scale=rd.scale,
                    )
                    rd._reset_cache()
                except Exception as e:  # noqa: BLE001 — per-read guard
                    errs[idx] = e
        if self.scale_iters < 0:
            return errs
        states = []
        for idx, rd in enumerate(reads):
            if errs[idx] is not None:
                continue
            origin = int(rd.seq_to_sig_map[0])
            states.append(
                {
                    "idx": idx,
                    "read": rd,
                    "levels": self.extract_levels(rd.int_seq),
                    "origin": origin,
                    "dacs": rd.dacs[origin : rd.seq_to_sig_map[-1]],
                    "map": rd.seq_to_sig_map - origin,
                    "shift": rd.shift,
                    "scale": rd.scale,
                    # post-rough-rescale values, frozen: the whole-batch
                    # host fallback restarts each read from scratch, so
                    # it must not see shift/scale mutated by completed
                    # device iterations (single-read-path equivalence)
                    "shift0": rd.shift,
                    "scale0": rd.scale,
                    "done": False,
                    "err": None,
                }
            )
        # per-read routing: reads whose INITIAL band already exceeds the
        # device width cap (long stalls/deletions are common in real
        # nanopore reads), or whose device traceback tensor would blow the
        # launch budget (N x W x 128 x int16 at the read's pow-2 width
        # bucket), go straight to the host DP; the rest share the device
        # launches. The in-loop guard still catches bands that grow past
        # the cap in later scale iterations.
        host_states = []
        if states:
            # config errors (bad budget env) fail fast, outside any
            # per-read guard that would silently reroute to the host
            tb_budget = _dp_tb_budget_bytes()
            device_states = []
            for st in states:
                try:
                    bd = _banded_search_space(
                        st["map"],
                        st["levels"],
                        st["dacs"].size,
                        self.half_bandwidth,
                        2,
                    )
                    w_read = int((bd[1] - bd[0]).max())
                    wide = w_read > REFINE_DEVICE_MAX_BAND or (
                        _dp_tb_bytes(st["levels"].size, w_read)
                        > tb_budget
                    )
                except Exception:  # noqa: BLE001 — let the loop report it
                    wide = False
                (host_states if wide else device_states).append(st)
            states = device_states
            HOST_ROUTED_READS += len(host_states)
            for st in host_states:
                rd = st["read"]
                try:
                    new_map, st["shift"], st["scale"] = self.refine_sig_map(
                        st["shift"],
                        st["scale"],
                        rd.seq_to_sig_map,
                        rd.int_seq,
                        rd.dacs,
                        backend=REFINE_BACKEND_AUTO,
                    )
                    st["map"] = new_map - st["origin"]
                except Exception as e:  # noqa: BLE001 — per-read guard
                    st["err"] = e
        if states:
            # config errors fail fast, before any launch: a bad
            # REMORA_TPU_REFINE_DP must raise, not silently reroute every
            # batch to the host DP
            _refine_dp_devices(self.dp_device)
            try:
                self._device_refine_loop(states)
            except DeviceDPRouteError as dev_err:
                # only the pre-launch guards (band wider than the device
                # cap, traceback over budget) reroute to the host DP; a
                # kernel that fails to build or launch propagates
                LOGGER.warning(
                    "device DP refinement rerouted "
                    f"({str(dev_err)[:200]}); "
                    f"running the host path for {len(states)} reads"
                )
                HOST_ROUTED_READS += len(states)
                for st in states:
                    rd = st["read"]
                    # a stale per-read error from the abandoned device
                    # loop must not mask this read's fresh host result
                    st["err"] = None
                    try:
                        # restart from the frozen post-rough-rescale
                        # state: the original map with shift/scale from
                        # a partially-completed device loop would be a
                        # hybrid neither path produces
                        new_map, st["shift"], st["scale"] = (
                            self.refine_sig_map(
                                st["shift0"],
                                st["scale0"],
                                rd.seq_to_sig_map,
                                rd.int_seq,
                                rd.dacs,
                                backend=REFINE_BACKEND_AUTO,
                            )
                        )
                        st["map"] = new_map - st["origin"]
                    except Exception as e:  # noqa: BLE001 — per-read
                        st["err"] = e
        for st in states + host_states:
            rd = st["read"]
            err = st["err"]
            if err is not None:
                if isinstance(err, IndexError):
                    # single-read parity: IndexError keeps the original
                    # mapping and carries on (data/read.py:233)
                    LOGGER.debug(
                        f"DP refinement IndexError ({rd.read_id}): {err}"
                    )
                else:
                    errs[st["idx"]] = err
                continue
            rd.seq_to_sig_map = st["map"] + st["origin"]
            rd.shift, rd.scale = st["shift"], st["scale"]
            rd._reset_cache()
        return errs

    def _device_refine_loop(self, states):
        """Run the scale_iters refine loop for many reads at once.

        Mutates each state's ``map``/``shift``/``scale`` in place; sets
        ``err`` on per-read failure (band build), ``done`` when a read
        stops early (precise rescale rejected — the single-read loop
        breaks there but keeps the refined map)."""
        global PLANNED_LAUNCHES
        import torch

        n_iters = max(self.scale_iters, 1)
        rescale_each = self.scale_iters > 0
        single_round = n_iters == 1

        # refine data parallelism: bucket launches are independent per
        # read, so they round-robin across the visible GPUs.
        # REMORA_TPU_REFINE_DP overrides the device count (0/1 = single
        # device). Launches are asynchronous: launches on different GPUs
        # run concurrently; the path fetch joins them.
        devices = _refine_dp_devices(self.dp_device)
        if len(devices) > 1:
            LOGGER.debug(
                f"device DP refinement over {len(devices)} local devices"
            )

        stage_cache = {}

        def staged(dev):
            """(sig, lvl) staging arrays on one device (lazy, cached)."""
            if single_round:
                return None, None
            if dev not in stage_cache:
                R = len(states)
                s_max = max(st["dacs"].size for st in states)
                n_max = max(st["levels"].size for st in states)
                sig_host = np.zeros((R, s_max), np.float32)
                lvl_host = np.zeros((R, n_max), np.float32)
                for r, st in enumerate(states):
                    sig_host[r, : st["dacs"].size] = st["dacs"]
                    lvl = np.nan_to_num(st["levels"], nan=0.0)
                    lvl_host[r, : lvl.size] = lvl
                stage_cache[dev] = (
                    torch.from_numpy(sig_host).to(dev),
                    torch.from_numpy(lvl_host).to(dev),
                )
            return stage_cache[dev]

        for _ in range(n_iters):
            active = []
            bands = []
            for r, st in enumerate(states):
                if st["done"] or st["err"] is not None:
                    continue
                try:
                    bands.append(
                        _banded_search_space(
                            st["map"],
                            st["levels"],
                            st["dacs"].size,
                            self.half_bandwidth,
                            2,
                        )
                    )
                    active.append(r)
                except Exception as e:  # noqa: BLE001 — per-read guard
                    st["err"] = e
            if not active:
                break
            w_need = max(int((bd[1] - bd[0]).max()) for bd in bands)
            if w_need > REFINE_DEVICE_MAX_BAND:
                # raised BEFORE any launch (the kernel's shared memory
                # holds at most this many rows); refine_reads_batch
                # catches this and reroutes the batch to the host DP
                raise DeviceDPRouteError(
                    f"band width {w_need} exceeds the device DP limit "
                    f"({REFINE_DEVICE_MAX_BAND}); read mapping likely "
                    "contains large deletions/stays"
                )
            tb_need = max(
                _dp_tb_bytes(
                    states[r]["levels"].size, int((bd[1] - bd[0]).max())
                )
                for r, bd in zip(active, bands)
            )
            if tb_need > _dp_tb_budget_bytes():
                raise DeviceDPRouteError(
                    f"DP traceback tensor ({tb_need >> 20} MB) exceeds "
                    "the per-launch device-memory budget "
                    "(REMORA_TPU_DP_TB_BUDGET_MB); band grew too wide"
                )
            # bucket reads by quantized band width: a launch's traceback
            # rows are the launch's W wide, so one wide-band read would
            # make every narrow read pay its traceback bytes (real sets
            # span 16..512 on the JAX package's bundled reads); the
            # buckets are the JAX package's, so launches are its launches
            buckets = {}
            for r, bd in zip(active, bands):
                w_read = max(16, int((bd[1] - bd[0]).max()))
                w_bucket = 1 << (w_read - 1).bit_length()
                buckets.setdefault(w_bucket, []).append((r, bd))
            launches = list(buckets.items())
            if len(devices) > 1 and len(launches) < len(devices):
                # a single dominant bucket would serialize on one GPU:
                # split its reads so every GPU gets work (per-read
                # independence makes any split path-exact)
                launches = [
                    (w, bucket[i::len(devices)])
                    for w, bucket in launches
                    for i in range(min(len(devices), len(bucket)))
                    if bucket[i::len(devices)]
                ]
            # chunk to at most 128 reads per launch: bigger buckets would
            # grow the (R, N, W) traceback tensor past what _dp_tb_bytes
            # (and the launch budget built on it) accounts for
            launches = [
                (w, bucket[i : i + _DP_LAUNCH_LANES])
                for w, bucket in launches
                for i in range(0, len(bucket), _DP_LAUNCH_LANES)
            ]
            # dispatch launches before fetching results (launches are
            # asynchronous, so launches on different GPUs overlap), but
            # bound the OUTSTANDING traceback bytes per device: every
            # enqueued launch holds its (R, N, W) int16 tensor in device
            # memory until its path fetch joins it, so unbounded dispatch
            # would let several near-budget tensors coexist and run a GPU
            # out of memory even though each launch passed the per-launch
            # guard.
            PLANNED_LAUNCHES += len(launches)
            budget = _dp_tb_budget_bytes()
            pending = []  # [dev, tb_bytes, bucket_active, lens, paths]
            outstanding = {}
            path_by_read = {}

            def drain(only_dev=None):
                for item in pending[:]:
                    if only_dev is not None and item[0] is not only_dev:
                        continue
                    _dev, tb_b, bucket_active, seq_lens, paths_dev = item
                    paths = paths_dev.cpu().numpy()
                    for a, r in enumerate(bucket_active):
                        # int32, matching the single-read path's dtype
                        path_by_read[r] = paths[a, : seq_lens[a] + 1].copy()
                    outstanding[_dev] -= tb_b
                    pending.remove(item)

            for li, (w_bucket, bucket) in enumerate(launches):
                dev = devices[li % len(devices)]
                n_max = max(
                    states[r]["levels"].size for r, _bd in bucket
                )
                tb_b = _dp_tb_bytes(n_max, w_bucket)
                if outstanding.get(dev, 0) + tb_b > budget:
                    drain(dev)
                sig_dev, lvl_dev = staged(dev)
                b_active, b_lens, paths_dev = self._launch_dp_bucket(
                    states, bucket, w_bucket, single_round,
                    sig_dev, lvl_dev, dev,
                )
                outstanding[dev] = outstanding.get(dev, 0) + tb_b
                pending.append([dev, tb_b, b_active, b_lens, paths_dev])
            drain()
            # rescale in the ORIGINAL bucket-major read order: the
            # precise rescale consumes the global NumPy RNG (reference
            # Theil–Sen subsample semantics), so the call order must not
            # depend on how launches were split across devices
            for _w, bucket in buckets.items():
                for r, _bd in bucket:
                    st = states[r]
                    st["map"] = path_by_read[r]
                    if not rescale_each:
                        continue
                    try:
                        st["shift"], st["scale"] = self.rescale(
                            st["levels"],
                            st["dacs"],
                            st["shift"],
                            st["scale"],
                            st["map"],
                        )
                    except RemoraError as err:
                        LOGGER.debug(f"precise re-scale skipped: {err}")
                        st["done"] = True

    def _launch_dp_bucket(self, states, bucket, w_bucket, single_round,
                          sig_dev, lvl_dev, dev):
        """Launch K4/K5 on ``dev`` for a width-bucketed subset of reads;
        returns (read_indices, seq_lens, paths_device_tensor) WITHOUT
        fetching, so launches round-robined across GPUs overlap (the
        caller joins and rescales in a stable order)."""
        import torch

        from remora_tpu_torch.kernels.banded_dp import banded_dp_batch

        active = [r for r, _bd in bucket]
        bands = [bd for _r, bd in bucket]
        n_act = max(states[r]["levels"].size for r in active)
        starts = np.zeros((len(active), n_act), np.int32)
        widths = np.ones((len(active), n_act), np.int32)
        seq_lens = np.zeros(len(active), np.int32)
        for a, (r, bd) in enumerate(zip(active, bands)):
            n = states[r]["levels"].size
            starts[a, :n] = bd[0]
            widths[a, :n] = bd[1] - bd[0]
            if n < n_act:
                starts[a, n:] = bd[1][-1] - 1
            seq_lens[a] = n
        if single_round:
            # exact single-read normalization semantics (host float64
            # broadcast then float32 cast) — bit-identical paths
            s_act = max(states[r]["dacs"].size for r in active)
            norm = np.zeros((len(active), s_act), np.float32)
            lvls = np.zeros((len(active), n_act), np.float32)
            for a, r in enumerate(active):
                st = states[r]
                norm[a, : st["dacs"].size] = (
                    st["dacs"] - st["shift"]
                ) / st["scale"]
                lv = np.nan_to_num(st["levels"], nan=0.0)
                lvls[a, : lv.size] = lv
        else:
            rows = torch.from_numpy(np.asarray(active, np.int64)).to(dev)
            shifts = torch.from_numpy(
                np.asarray([states[r]["shift"] for r in active],
                           np.float32)
            ).to(dev)
            scales = torch.from_numpy(
                np.asarray([states[r]["scale"] for r in active],
                           np.float32)
            ).to(dev)
            norm = (sig_dev[rows] - shifts[:, None]) / scales[:, None]
            lvls = lvl_dev[rows, :n_act]
        # the BUCKET width (pow-2), not the raw per-launch max, as the
        # JAX package launches it: the traceback rows are that wide
        paths, _tb, _ = banded_dp_batch(
            norm,
            lvls,
            starts,
            widths,
            seq_lens,
            np.asarray(self.sd_arr, np.float32),
            algo=self.algo,
            w_max=w_bucket,
            device=dev,
        )
        return active, seq_lens, paths

    # --- (de)serialization ---
    # metadata key <-> constructor kwarg; key names are the on-disk
    # compat contract shared with dataset/checkpoint metadata
    _META_KEYS = (
        ("refine_kmer_levels", "_levels_array"),
        ("refine_kmer_center_idx", "center_idx"),
        ("refine_do_rough_rescale", "do_rough_rescale"),
        ("refine_scale_iters", "scale_iters"),
        ("refine_algo", "algo"),
        ("refine_half_bandwidth", "half_bandwidth"),
        ("refine_sd_arr", "sd_arr"),
        ("rough_rescale_method", "rough_rescale_method"),
    )

    def asdict(self):
        out = {key: getattr(self, attr) for key, attr in self._META_KEYS}
        out["refine_kmer_levels"] = (
            self.levels_array if self.is_loaded else None
        )
        return out

    @classmethod
    def load_from_metadata(cls, metadata):
        # absent/None keys defer to the dataclass defaults: metadata
        # without refine_* entries (e.g. a migrated legacy dataset)
        # yields an unloaded no-op refiner instead of None-typed fields
        kwargs = {
            attr: metadata[key]
            for key, attr in cls._META_KEYS
            if metadata.get(key) is not None
        }
        kwargs.setdefault(
            "rough_rescale_method", ROUGH_RESCALE_LEAST_SQUARES
        )
        return cls(**kwargs)

    @classmethod
    def load_from_dict(cls, data, **kwargs):
        (first_kmer,) = islice(data, 1)
        return cls(str_kmer_levels=data, kmer_len=len(first_kmer), **kwargs)

    def __eq__(self, other):
        """Equality on the settings that affect refinement behavior.

        Tiered: scaling mode first; when neither instance rescales or
        refines the rest is irrelevant; DP settings only matter when
        refinement iterations are enabled.
        """
        if other.__class__ is not SigMapRefiner:
            return False
        mode = (self.do_rough_rescale, self.scale_iters)
        if mode != (other.do_rough_rescale, other.scale_iters):
            return False
        if not mode[0] and mode[1] < 0:
            # neither rescales nor refines: remaining settings are inert
            return True
        same_table = (
            self.rough_rescale_method == other.rough_rescale_method
            and self.center_idx == other.center_idx
            and np.array_equal(self._levels_array, other._levels_array)
        )
        if not same_table:
            return False
        if self.scale_iters < 0:
            return True
        return (
            self.algo == other.algo
            and self.half_bandwidth == other.half_bandwidth
            and np.array_equal(self.sd_arr, other.sd_arr)
        )

    def get_sub_kmer_table(self, sub_kmer_size):
        """Mean levels for a smaller k-mer centered on the dominant position.

        Returns a list of (sub_kmer, mean_level, dominant_base) sorted by
        level (the reference returns a polars frame; plain tuples here).
        """
        if not sub_kmer_size < self.kmer_len:
            raise RemoraError(
                "Requested sub-k-mer is not smaller than the stored k-mer"
            )
        if self.kmer_idx_stats is None:
            self._determine_dominant_pos()
        # grow a window around the dominant position, preferring the side
        # with the stronger positional effect
        lo = hi = self.center_idx
        focus_off = 0
        for _ in range(sub_kmer_size - 1):
            grow_left = hi + 1 == self.kmer_len or (
                lo > 0 and self.kmer_idx_stats[lo - 1] > self.kmer_idx_stats[hi + 1]
            )
            if grow_left:
                lo -= 1
                focus_off += 1
            else:
                hi += 1
        sums = {}
        for kmer, level in zip(self.kmers, self.levels_array):
            sub = kmer[lo : lo + sub_kmer_size]
            tot, cnt = sums.get(sub, (0.0, 0))
            sums[sub] = (tot + float(level), cnt + 1)
        rows = [
            (sub, tot / cnt, sub[focus_off])
            for sub, (tot, cnt) in sums.items()
        ]
        rows.sort(key=lambda r: r[1])
        return rows
