"""IO-side read: signal, basecalls, scaling domains, reference alignment.

Reference analog: ``io.Read`` (``src/remora/io.py:1746–2479``). Carries
the three scaling domains (pA, zero-centered pA, norm), parses move
table + trim/scaling BAM tags, computes ref_to_signal through the CIGAR,
and bridges into the data-layer RemoraRead.

Copy of ``remora_tpu/io/read.py``, importing this package's modules.
"""

from copy import copy, deepcopy
from dataclasses import dataclass
from typing import Optional

import numpy as np

from remora_tpu_torch import RemoraError, log
from remora_tpu_torch.constants import PA_TO_NORM_SCALING_FACTOR
from remora_tpu_torch.core import coords, seq as sequtil
from remora_tpu_torch.core.metrics import METRIC_FUNCS
from remora_tpu_torch.data.read import RemoraRead
from remora_tpu_torch.io.refregion import RefRegion

LOGGER = log.get_logger()


def _rescaled(values, shift, scale, domain):
    """(values - shift) / scale, with a clear error when factors are unset."""
    if shift is None or scale is None:
        raise RemoraError(f"{domain} scaling factors not set")
    return (values - shift) / scale


@dataclass
class ReadRefReg:
    read_id: "str"
    norm_signal: np.ndarray
    seq: "str"
    seq_to_sig_map: np.ndarray
    ref_reg: RefRegion
    sig_start: "int" = 0


@dataclass
class ReadBasecallRegion:
    read_id: "str"
    norm_signal: np.ndarray
    seq: "str"
    seq_to_sig_map: np.ndarray
    start: "int"
    sig_start: "int" = 0


@dataclass
class Read:
    """All scaling parameters follow output = (input - shift) / scale."""

    read_id: str
    dacs: Optional[np.ndarray] = None
    seq: Optional[str] = None
    stride: Optional[int] = None
    mv_table: Optional[np.ndarray] = None
    query_to_signal: Optional[np.ndarray] = None
    shift_dacs_to_pa: Optional[float] = None
    scale_dacs_to_pa: Optional[float] = None
    shift_pa_to_norm: Optional[float] = None
    scale_pa_to_norm: Optional[float] = None
    shift_dacs_to_norm: Optional[float] = None
    scale_dacs_to_norm: Optional[float] = None
    shift_pa_to_zc_pa: Optional[float] = None
    scale_pa_to_zc_pa: Optional[float] = None
    ref_seq: Optional[str] = None
    ref_reg: Optional[RefRegion] = None
    cigar: Optional[list] = None
    ref_to_signal: Optional[np.ndarray] = None
    full_align: object = None  # BamRecord of the originating alignment
    _child_read_id: Optional[str] = None
    _sig_len: Optional[int] = None

    # --- scaling domains ---
    @property
    def pa_signal(self):
        return _rescaled(
            self.dacs, self.shift_dacs_to_pa, self.scale_dacs_to_pa, "pA"
        )

    @property
    def zero_centered_pa_signal(self):
        return _rescaled(
            self.dacs,
            self.shift_dacs_to_zc_pa,
            self.scale_dacs_to_zc_pa,
            "Zero-centered pA",
        )

    @property
    def norm_signal(self):
        return _rescaled(
            self.dacs, self.shift_dacs_to_norm, self.scale_dacs_to_norm, "Norm"
        )

    def compute_pa_to_norm_scaling(self, factor=PA_TO_NORM_SCALING_FACTOR):
        """med/MAD normalization parameters from the pA signal."""
        pa = self.pa_signal
        self.shift_pa_to_norm = np.median(pa)
        mad = np.median(np.abs(pa - self.shift_pa_to_norm))
        self.scale_pa_to_norm = max(1.0, mad * factor)

    def _zc_factors(self):
        triple = (
            self.shift_dacs_to_pa,
            self.scale_dacs_to_pa,
            self.shift_pa_to_zc_pa,
            self.scale_pa_to_zc_pa,
        )
        if any(v is None for v in triple):
            raise RemoraError("Zero-centered pA scaling factors not set")
        return triple

    @property
    def shift_dacs_to_zc_pa(self):
        d2p_shift, d2p_scale, zc_shift, _ = self._zc_factors()
        return d2p_shift + d2p_scale * zc_shift

    @property
    def scale_dacs_to_zc_pa(self):
        _, d2p_scale, _, zc_scale = self._zc_factors()
        return d2p_scale * zc_scale

    _SIG_DOMAINS = {
        "norm": "norm_signal",
        "pa": "pa_signal",
        "zc_pa": "zero_centered_pa_signal",
        "dac": "dacs",
    }

    def get_sig_type(self, signal_type):
        try:
            return getattr(self, self._SIG_DOMAINS[signal_type])
        except KeyError:
            raise RemoraError(f"Invalid signal_type: {signal_type}")

    # --- basic geometry ---
    @property
    def sig_len(self):
        cached = self._sig_len
        if cached is None and self.dacs is not None:
            cached = self._sig_len = self.dacs.size
        return cached

    @staticmethod
    def _anchor_len(mapping, sequence):
        if mapping is not None:
            return mapping.size - 1
        return None if sequence is None else len(sequence)

    @property
    def seq_len(self):
        return self._anchor_len(self.query_to_signal, self.seq)

    @property
    def ref_seq_len(self):
        return self._anchor_len(self.ref_to_signal, self.ref_seq)

    @property
    def child_read_id(self):
        return self._child_read_id or self.read_id

    def prune(self, drop_mod_tags=True, drop_move_tag=True):
        """Drop large arrays once chunks have been extracted."""
        unwanted_tags = set()
        if drop_mod_tags:
            unwanted_tags |= {"MM", "ML"}
        if drop_move_tag:
            unwanted_tags.add("mv")
        if unwanted_tags and self.full_align is not None:
            self.full_align.drop_tags(unwanted_tags)
        self.sig_len  # cache before dropping
        for attr in ("dacs", "mv_table", "query_to_signal", "ref_to_signal"):
            setattr(self, attr, None)
        return self

    # --- alignment attachment, decomposed into steps ---
    def _trim_signal(self, tags, reverse_signal):
        """Apply split-read (sp) and adapter (ts/ns) signal trims."""
        sig = self.dacs if not reverse_signal else self.dacs[::-1]
        sig = sig[tags.get("sp", 0) :]
        lo, hi = tags.get("ts", 0), tags.get("ns", sig.size)
        sig = sig[lo:hi]
        self.dacs = sig if not reverse_signal else sig[::-1]
        self._sig_len = None

    def _check_identity(self, alignment_record, tags):
        """Verify record/read identity, tracking split-read children."""
        record_id = alignment_record.query_name
        parent_id = tags.get("pi")
        expect = record_id if parent_id is None else parent_id
        if expect != self.read_id:
            kind = "Record" if parent_id is None else "Split-read parent"
            raise RemoraError(f"{kind} ID does not match signal read ID")
        if parent_id is not None:
            self._child_read_id = record_id

    def _attach_moves(self, tags, reverse_signal):
        if "mv" not in tags:
            LOGGER.debug(f"No move table on record {self.child_read_id}")
            self.stride = None
            self.mv_table = None
            self.query_to_signal = None
            return
        mv_tag = tags["mv"]
        self.stride = int(mv_tag[0])
        self.mv_table = np.asarray(mv_tag[1:])
        nbases = len(self.seq)
        self.query_to_signal = coords.parse_move_table(
            self.stride,
            self.mv_table,
            seq_len=nbases,
            reverse_signal=reverse_signal,
            sig_len=self.sig_len,
        )

    def _attach_norm_scaling(self, tags):
        sm, sd = tags.get("sm"), tags.get("sd")
        if sm is None or sd is None:
            self.compute_pa_to_norm_scaling()
        else:
            self.shift_pa_to_norm, self.scale_pa_to_norm = sm, sd
        d2p_shift, d2p_scale = self.shift_dacs_to_pa, self.scale_dacs_to_pa
        self.shift_dacs_to_norm = (
            d2p_shift + d2p_scale * self.shift_pa_to_norm
        )
        self.scale_dacs_to_norm = d2p_scale * self.scale_pa_to_norm

    def _attach_reference(self, alignment_record):
        mapped_reverse = alignment_record.is_reverse
        strand = "-" if mapped_reverse else "+"
        self.ref_reg = RefRegion(
            alignment_record.reference_name,
            strand,
            alignment_record.reference_start,
        )
        try:
            md_seq = alignment_record.get_reference_sequence()
        except (ValueError, KeyError):
            LOGGER.debug(
                "Could not extract reference sequence — missing MD tags?"
            )
            md_seq = None
        self.ref_seq = md_seq.upper() if md_seq is not None else None
        cig = alignment_record.cigartuples
        if mapped_reverse:
            cig = cig[::-1]
            if self.ref_seq is not None:
                self.ref_seq = sequtil.revcomp(self.ref_seq)
        self.cigar = cig
        needed = (self.ref_reg.ctg, self.ref_seq, self.query_to_signal)
        if any(v is None for v in needed):
            return
        self.ref_to_signal = coords.compute_ref_to_signal(
            cigar=self.cigar, query_to_signal=self.query_to_signal
        )
        self._check_ref_map_len()
        reg = self.ref_reg
        reg.end = reg.start + self.ref_seq_len

    def add_alignment(
        self,
        alignment_record,
        *,
        pa_scaling=None,
        reverse_signal=False,
        parse_ref_align=True,
    ):
        """Attach a BamRecord: trims, move table, scaling tags, ref mapping."""
        if pa_scaling is not None:
            self.shift_pa_to_zc_pa, self.scale_pa_to_zc_pa = pa_scaling
        if alignment_record.is_reverse and (
            alignment_record.reference_name is None
        ):
            raise RemoraError("Reverse-strand record with no mapping")
        if self.dacs is None:
            raise RemoraError("Signal must be attached before an alignment")
        self.full_align = alignment_record

        tags = alignment_record.tag_dict()
        self._trim_signal(tags, reverse_signal)
        self._check_identity(alignment_record, tags)
        basecalls = alignment_record.query_sequence
        self.seq = (
            sequtil.revcomp(basecalls)
            if alignment_record.is_reverse
            else basecalls
        )
        self._attach_moves(tags, reverse_signal)
        self._attach_norm_scaling(tags)
        if parse_ref_align and not alignment_record.is_unmapped:
            self._attach_reference(alignment_record)

    @classmethod
    def from_pod5_record(cls, pod5_read, rev_sig=False, **extra):
        """Build a signal-only Read from a POD5 record.

        remora_tpu_torch Calibration is already in (x - shift) / scale form."""
        sig = pod5_read.signal
        cal = pod5_read.calibration
        return cls(
            str(pod5_read.read_id),
            dacs=sig if not rev_sig else sig[::-1],
            shift_dacs_to_pa=cal.offset,
            scale_dacs_to_pa=cal.scale,
            **extra,
        )

    @classmethod
    def from_pod5_and_alignment(
        cls, pod5_read_record, alignment_record, *, pa_scaling=None,
        reverse_signal=False,
    ):
        read = cls.from_pod5_record(pod5_read_record, rev_sig=reverse_signal)
        read.add_alignment(
            alignment_record,
            pa_scaling=pa_scaling,
            reverse_signal=reverse_signal,
        )
        return read

    def _check_ref_map_len(self):
        want = len(self.ref_seq) + 1
        if self.ref_to_signal.size != want:
            raise RemoraError("ref mapping length disagrees with ref seq")

    def _ensure_ref_to_signal(self):
        if self.ref_to_signal is not None:
            return
        if None in (self.cigar, self.ref_seq):
            raise RemoraError("Missing reference alignment")
        self.ref_to_signal = coords.compute_ref_to_signal(
            self.query_to_signal, self.cigar
        )
        self._check_ref_map_len()

    def into_remora_read(self, use_reference_anchor):
        """Extract the data-layer RemoraRead (ref- or basecall-anchored)."""
        if not use_reference_anchor:
            if self.query_to_signal is None:
                raise RemoraError("No query_to_signal mapping (mv tag missing?)")
            anchor_map, anchor_seq = self.query_to_signal, self.seq
        else:
            self._ensure_ref_to_signal()
            anchor_map, anchor_seq = self.ref_to_signal, self.ref_seq

        if None in (self.shift_pa_to_zc_pa, self.scale_pa_to_zc_pa):
            shift, scale = self.shift_dacs_to_norm, self.scale_dacs_to_norm
        else:
            shift, scale = self.shift_dacs_to_zc_pa, self.scale_dacs_to_zc_pa
        lo = anchor_map[0]
        bridged = RemoraRead(
            dacs=self.dacs[lo : anchor_map[-1]],
            shift=shift,
            scale=scale,
            seq_to_sig_map=anchor_map - lo,
            str_seq=anchor_seq,
            read_id=self.read_id,
        )
        bridged.check()
        return bridged

    def set_refine_signal_mapping(self, sig_map_refiner, ref_mapping=False):
        """Refine the basecall- or reference-anchored signal mapping in place."""
        if sig_map_refiner is None:
            return
        bridged = self.into_remora_read(ref_mapping)
        bridged.refine_signal_mapping(sig_map_refiner)
        map_attr = "ref_to_signal" if ref_mapping else "query_to_signal"
        current_map = getattr(self, map_attr)
        if current_map is None:
            raise RemoraError(f"Missing {map_attr} (move table)")
        setattr(self, map_attr, bridged.seq_to_sig_map + current_map[0])
        # fold refined norm params back through the pA domain
        d2p_shift, d2p_scale = self.shift_dacs_to_pa, self.scale_dacs_to_pa
        self.shift_dacs_to_norm = bridged.shift
        self.scale_dacs_to_norm = bridged.scale
        self.shift_pa_to_norm = (bridged.shift - d2p_shift) / d2p_scale
        self.scale_pa_to_norm = bridged.scale / d2p_scale

    # --- focus position selection ---
    def get_filtered_focus_positions(self, select_focus_positions):
        """Read-relative positions from a (ctg, strand)->set lookup."""
        reg = self.ref_reg
        if reg is None or self.ref_seq is None:
            raise RemoraError(
                "Focus position selection requires a reference mapping"
            )
        ref_len = len(self.ref_seq)
        focus_set = select_focus_positions.get((reg.ctg, reg.strand))
        if focus_set is None:
            return np.empty(0, dtype=int)
        within = focus_set.intersection(range(reg.start, reg.start + ref_len))
        hits = np.array(sorted(within), dtype=int)
        if reg.strand == "+":
            return hits - reg.start
        return reg.start + ref_len - hits[::-1] - 1

    def get_basecall_anchored_focus_bases(
        self, motifs, select_focus_reference_positions
    ):
        """Basecall positions whose reference mates hit a motif/BED site."""
        if self.cigar is None:
            raise RemoraError("focus-base anchoring needs an alignment")
        bc_focus = sequtil.find_focus_bases(
            sequtil.seq_to_int(self.seq), motifs
        )
        if select_focus_reference_positions is None:
            ref_focus = sequtil.find_focus_bases(
                sequtil.seq_to_int(self.ref_seq), motifs
            )
        else:
            ref_focus = self.get_filtered_focus_positions(
                select_focus_reference_positions
            )
        ref_to_query = coords.make_sequence_coordinate_mapping(
            self.cigar
        ).astype(int)
        supported = ref_to_query[ref_focus]
        return bc_focus[np.isin(bc_focus, supported)]

    def copy(self):
        return deepcopy(self)

    # --- region extraction / metrics ---
    def _strand_window(self, region):
        """Read-relative (start, end) base coordinates of a ref region."""
        if self.ref_reg.strand == "+":
            return (
                region.start - self.ref_reg.start,
                region.end - self.ref_reg.start,
            )
        return (
            self.ref_reg.end - region.end,
            self.ref_reg.end - region.start,
        )

    def extract_basecall_region(self, *, start_base=None, end_base=None,
                                signal_type="norm"):
        if self.query_to_signal is None:
            raise RemoraError("No query_to_signal mapping (mv tag missing?)")
        lo = start_base or 0
        hi = end_base or self.seq_len
        reg_map = np.array(self.query_to_signal[lo : hi + 1])
        sig_start = reg_map[0]
        reg_sig = self.get_sig_type(signal_type)[sig_start : reg_map[-1]]
        return ReadBasecallRegion(
            self.read_id,
            reg_sig,
            self.seq[lo:hi],
            reg_map - sig_start,
            lo,
            sig_start=sig_start,
        )

    def extract_ref_reg(self, ref_reg, *, signal_type="norm"):
        if self.ref_to_signal is None:
            raise RemoraError("No ref_to_signal mapping (unaligned read?)")
        read_reg = self.ref_reg
        read_hi = read_reg.start + self.ref_seq_len
        if not (read_reg.start <= ref_reg.end and ref_reg.start < read_hi):
            raise RemoraError("requested region misses the read span")

        win_lo, win_hi = self._strand_window(ref_reg)
        win_lo = max(win_lo, 0)
        map_window = self.ref_to_signal[win_lo : win_hi + 1].copy()
        sig_start = map_window[0]
        sig_window = self.get_sig_type(signal_type)[sig_start : map_window[-1]]
        seq_window = self.ref_seq[win_lo:win_hi]
        map_window -= sig_start
        if read_reg.strand == "-":
            # emit in reference orientation
            sig_window = sig_window[::-1]
            seq_window = seq_window[::-1]
            map_window = map_window[-1] - map_window[::-1]
        out_start = max(read_reg.start, ref_reg.start)
        out_reg = RefRegion(
            read_reg.ctg,
            read_reg.strand,
            out_start,
            out_start + len(seq_window),
        )
        return ReadRefReg(
            self.read_id,
            sig_window,
            seq_window,
            map_window,
            out_reg,
            sig_start=sig_start,
        )

    def _region_seq_to_sig(self, region, ref_anchored):
        """Mapping slice for a region + NaN-pad amounts at the edges."""
        if not ref_anchored:
            if self.query_to_signal is None:
                raise RemoraError(
                    "No query_to_signal mapping (mv tag missing?)"
                )
            if not 0 <= region.start <= self.seq_len:
                raise RemoraError("region outside basecalls")
            return self.query_to_signal[region.start : region.end], 0, 0
        if self.ref_to_signal is None:
            raise RemoraError("No ref_to_signal mapping (unaligned read?)")
        mine = (self.ref_reg.ctg, self.ref_reg.strand)
        if mine != (region.ctg, region.strand):
            raise RemoraError("region contig/strand differ from the read")
        overlaps = (
            region.start < self.ref_reg.end
            and self.ref_reg.start < region.end
        )
        if not overlaps:
            raise RemoraError("region misses the read span")
        win_lo, win_hi = self._strand_window(region)
        pad_lo = max(-win_lo, 0)
        pad_hi = max(win_hi - self.ref_seq_len, 0)
        window = self.ref_to_signal[win_lo + pad_lo : win_hi - pad_hi + 1]
        return window, pad_lo, pad_hi

    def compute_per_base_metric(
        self,
        metric=None,
        *,
        metric_func=None,
        signal_type="norm",
        region=None,
        ref_anchored=True,
        **kwargs,
    ):
        if metric is None and metric_func is None:
            raise RemoraError("need a metric name or a metric_func")
        if metric is not None:
            metric_func = METRIC_FUNCS[metric]
        if region is not None:
            seq_to_sig, pad_lo, pad_hi = self._region_seq_to_sig(
                region, ref_anchored
            )
        else:
            pad_lo = pad_hi = 0
            attr = "ref_to_signal" if ref_anchored else "query_to_signal"
            seq_to_sig = getattr(self, attr)
            if seq_to_sig is None:
                raise RemoraError("no move table on this read")
        sig = self.get_sig_type(signal_type)
        metric_values = metric_func(sig, seq_to_sig, **kwargs)
        if pad_lo or pad_hi:
            # NaN-pad metric rows out to the full requested region
            padded = {}
            for name, vals in metric_values.items():
                row = np.full(region.len, np.nan)
                row[pad_lo : pad_lo + vals.size] = vals
                padded[name] = row
            metric_values = padded
        return metric_values

    def with_duplex_alignment(self, duplex_read_alignment, duplex_orientation):
        """Copy re-anchored onto a duplex basecall (see remora_tpu_torch.io.duplex)."""
        from remora_tpu_torch.io import duplex as duplex_mod

        if self.query_to_signal is None:
            raise RemoraError("requires query_to_signal")
        duplex_seq = duplex_read_alignment.query_sequence
        if not duplex_seq:
            raise RemoraError("duplex record carries no basecalls")
        if not duplex_orientation:
            duplex_seq = sequtil.revcomp(duplex_seq)

        read = copy(self)
        mapping = duplex_mod.map_simplex_to_duplex(
            simplex_seq=read.seq, duplex_seq=duplex_seq
        )
        read.query_to_signal = coords.map_ref_to_signal(
            query_to_signal=read.query_to_signal,
            ref_to_query_knots=mapping.duplex_to_simplex_mapping,
        )
        read.seq = mapping.trimmed_duplex_seq
        read.ref_seq = read.ref_to_signal = read.ref_reg = None
        return read, mapping.duplex_offset


def iter_signal(pod5_path, *, num_reads=None, read_ids=None, rev_sig=False,
                pa_scaling=None):
    """Yield (Read, err) with signal loaded from POD5.

    Reference analog ``io.py:441–474``. Calibration arrives from
    remora_tpu_torch.io.pod5 already in (x - shift) / scale form, so both this
    path and ``Read.from_pod5_and_alignment`` produce identical (and
    physically sensible) pA scaling — the reference's two entry points
    disagree on this convention; we follow the pipeline one, which is
    consistent with the sm/sd BAM tags.
    """
    from remora_tpu_torch.io.pod5 import DatasetReader

    extra = {}
    if pa_scaling is not None:
        extra = dict(
            zip(("shift_pa_to_zc_pa", "scale_pa_to_zc_pa"), pa_scaling)
        )
    remaining = num_reads if num_reads is not None else -1
    with DatasetReader(pod5_path) as pod5_dr:
        for pod5_read in pod5_dr.reads(selection=read_ids):
            if remaining == 0:
                LOGGER.debug(f"Signal worker hit read limit ({num_reads})")
                return
            remaining -= 1
            yield Read.from_pod5_record(pod5_read, rev_sig, **extra), None
    LOGGER.debug("Completed signal worker")


def extract_alignments(read_err, bam_idx, rev_sig=False, pa_scaling=None):
    """Join one signal Read against all of its BAM alignments."""
    source_read, err = read_err
    if source_read is None:
        return [read_err]
    joined = []
    try:
        for bam_read in bam_idx.get_alignments(source_read.read_id):
            candidate = source_read.copy()
            try:
                candidate.add_alignment(
                    bam_read,
                    pa_scaling=pa_scaling,
                    reverse_signal=rev_sig,
                )
            except RemoraError as e:
                LOGGER.debug(
                    f"attach failed ({source_read.read_id}): {e}"
                )
                joined.append((candidate, str(e)))
            else:
                joined.append((candidate, None))
    except RemoraError as e:
        LOGGER.debug(f"attach failed ({source_read.read_id}): {e}")
        return [(source_read, str(e))]
    return joined
