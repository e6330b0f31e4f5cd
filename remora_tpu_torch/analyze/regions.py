"""Reference-region pileup utilities.

Copy of ``remora_tpu/analyze/regions.py`` over this package's modules.

Reference analog ``src/remora/io.py:523–1044``: region iteration with
coverage-capped sampling, region sequence/level reconstruction from
covering reads, per-region per-base metrics.

Region queries run as overlap filters over the in-memory record index
(remora_tpu BAM files are scanned once and held decompressed; a BAI-style
interval index can be added for very large files).
"""

import random

import numpy as np

from remora_tpu_torch import RemoraError, log
from remora_tpu_torch.core import seq as sequtil
from remora_tpu_torch.io.bam import FastBamScanner
from remora_tpu_torch.io.read import Read
from remora_tpu_torch.io.read_index import get_parent_id, read_is_primary, strands_match
from remora_tpu_torch.io.refregion import RefRegion

LOGGER = log.get_logger()

UNCOVERED = -2  # pileup code for "no read spans this position"


class RegionIndexedBam:
    """Overlap queries over a scanned BAM (reference ``fetch`` analog)."""

    def __init__(self, bam_path):
        self.scanner = FastBamScanner(bam_path)
        self.header = self.scanner.header
        self._by_ref = {}
        for rec in self.scanner:
            if rec.is_unmapped:
                continue
            self._by_ref.setdefault(rec.reference_name, []).append(rec)
        for recs in self._by_ref.values():
            recs.sort(key=lambda r: r.reference_start)

    def fetch(self, ctg, start, end, strand=None):
        for rec in self._by_ref.get(ctg, ()):
            if rec.reference_start >= end:
                return
            if rec.reference_end <= start or not strands_match(strand, rec):
                continue
            yield rec


def iter_regions(bam, reg_len=100_000):
    """Tile every contig into reg_len windows on both strands."""
    header = bam.header
    for ctg, ctg_len in zip(header.references, header.lengths):
        for win_start in range(0, ctg_len + 1, reg_len):
            for strand in "+-":
                yield RefRegion(
                    ctg=ctg,
                    start=win_start,
                    end=win_start + reg_len,
                    strand=strand,
                )


def get_reg_bam_reads(ref_reg, bam):
    fetched = bam.fetch(ref_reg.ctg, ref_reg.start, ref_reg.end, None)
    return [
        rec
        for rec in fetched
        if read_is_primary(rec) and strands_match(ref_reg.strand, rec)
    ]


def _sample_region_reads(ref_reg, bam, max_reads):
    """Region's primary reads, down-sampled to at most max_reads."""
    bam_reads = get_reg_bam_reads(ref_reg, bam)
    if not bam_reads:
        raise RemoraError(f"Region {ref_reg.ctg}:{ref_reg.start} has no covering reads")
    if max_reads is not None and len(bam_reads) > max_reads:
        bam_reads = random.sample(bam_reads, max_reads)
    return bam_reads


def iter_covered_regions(bam_path, *, chunk_len=1_000, max_chunk_cov=None):
    """Yield (region, covering reads), optionally capping total coverage."""
    bam = RegionIndexedBam(bam_path)
    for reg in iter_regions(bam, chunk_len):
        bam_reads = get_reg_bam_reads(reg, bam)
        if not bam_reads:
            continue
        if max_chunk_cov is not None:
            # take random reads until the per-region base budget is spent
            budget = chunk_len * max_chunk_cov
            random.shuffle(bam_reads)
            kept = []
            for rec in bam_reads:
                kept.append(rec)
                span_lo = max(rec.reference_start, reg.start)
                span_hi = min(rec.reference_end, reg.end)
                budget -= span_hi - span_lo
                if budget <= 0:
                    break
            bam_reads = kept
        yield reg, bam_reads


def get_ref_int_seq_from_reads(ref_reg, bam_reads, *, ref_orient=True):
    """Forward reference int sequence pieced together from read MD tags.

    Positions no read covers are left at UNCOVERED (-2).
    """
    pile = np.full(ref_reg.len, UNCOVERED, np.int32)
    for rec in bam_reads:
        lo, hi = ref_reg.clamp(rec.reference_start, rec.reference_end)
        if hi <= lo:
            continue
        md_seq = rec.get_reference_sequence().upper()
        piece = md_seq[lo - rec.reference_start : hi - rec.reference_start]
        pile[lo - ref_reg.start : hi - ref_reg.start] = sequtil.seq_to_int(
            piece
        )
        if UNCOVERED not in pile:
            break
    if ref_reg.strand == "-":
        flipped = pile.copy()
        covered = flipped >= 0
        flipped[covered] = sequtil.comp_int(flipped[covered])
        return flipped if ref_orient else flipped[::-1]
    return pile


def get_ref_seq_from_reads(ref_reg, bam_reads, *, ref_orient=True):
    pile = get_ref_int_seq_from_reads(
        ref_reg, bam_reads, ref_orient=ref_orient
    )
    return sequtil.int_to_seq(np.maximum(pile, -1))


def get_ref_seq_and_levels_from_reads(
    ref_reg, bam_reads, sig_map_refiner, *, ref_orient=True
):
    """Sequence + expected levels for a region from covering reads."""
    if sig_map_refiner is None or not sig_map_refiner.is_loaded:
        ctx = get_ref_int_seq_from_reads(
            ref_reg, bam_reads, ref_orient=False
        )
        levels = None
        seq = sequtil.int_to_seq(np.maximum(ctx, -1))
    else:
        # pad the region by the k-mer context so edge levels are defined
        bb, ba = sig_map_refiner.bases_before, sig_map_refiner.bases_after
        padded_reg = ref_reg.adjust(-bb, ba, ref_orient=False)
        ctx = get_ref_int_seq_from_reads(
            padded_reg, bam_reads, ref_orient=False
        )
        no_data = ctx == UNCOVERED
        levels = sig_map_refiner.extract_levels(np.clip(ctx, -1, 3))
        levels[no_data] = np.nan
        seq = sequtil.int_to_seq(np.maximum(ctx, -1))[bb : bb + ref_reg.len]
        levels = levels[bb : bb + ref_reg.len]
    if ref_orient and ref_reg.strand == "-":
        seq = seq[::-1]
        levels = None if levels is None else levels[::-1]
    return seq, levels


def get_pod5_reads(pod5_dr, ids):
    """Read records by id (reference analog ``io.get_pod5_reads``
    io.py:768–772)."""
    wanted = pod5_dr.reads(selection=list(ids))
    return {str(p5.read_id): p5 for p5 in wanted}


def get_io_reads(
    bam_reads, pod5_dr, reverse_signal=False, *, pa_scaling=None,
    missing_ok=False
):
    """Join BAM records with their POD5 signal into io Reads."""
    signal_by_id = get_pod5_reads(
        pod5_dr, set(map(get_parent_id, bam_reads))
    )
    joined = []
    for rec in bam_reads:
        try:
            joined.append(
                Read.from_pod5_and_alignment(
                    pod5_read_record=signal_by_id[get_parent_id(rec)],
                    alignment_record=rec,
                    reverse_signal=reverse_signal,
                    pa_scaling=pa_scaling,
                )
            )
        except Exception:
            if not missing_ok:
                raise RemoraError("BAM record not found in POD5")
    return joined


def _maybe_refine(io_reads, sig_map_refiner, skip_refine, require_loaded=False):
    if sig_map_refiner is None or skip_refine:
        return
    if require_loaded and not sig_map_refiner.is_loaded:
        return
    for rd in io_reads:
        rd.set_refine_signal_mapping(sig_map_refiner, ref_mapping=True)


def get_reads_reference_regions(
    ref_reg,
    pod5_bam_pairs,
    *,
    max_reads=50,
    sig_map_refiner=None,
    skip_sig_map_refine=False,
    signal_type="norm",
    reverse_signal=False,
    pa_scaling=None,
    missing_ok=False,
):
    """Per-sample lists of per-read region extracts (plus the BAM reads)."""
    sampled_bam_reads = []
    region_extracts = []
    for pod5_dr, bam in pod5_bam_pairs:
        sample_reads = _sample_region_reads(ref_reg, bam, max_reads)
        sampled_bam_reads.append(sample_reads)
        io_reads = get_io_reads(
            sample_reads, pod5_dr,
            reverse_signal=reverse_signal,
            pa_scaling=pa_scaling,
            missing_ok=missing_ok,
        )
        _maybe_refine(io_reads, sig_map_refiner, skip_sig_map_refine)
        region_extracts.append(
            [rd.extract_ref_reg(ref_reg, signal_type=signal_type)
             for rd in io_reads]
        )
    return region_extracts, sampled_bam_reads


def get_ref_reg_sample_metrics(
    ref_reg,
    pod5_dr,
    bam_reads,
    metric,
    sig_map_refiner,
    *,
    skip_sig_map_refine=False,
    ref_orient=True,
    signal_type="norm",
    reverse_signal=False,
    pa_scaling=None,
    missing_ok=False,
    **kwargs,
):
    """Stacked per-read metric arrays over one region for one sample."""
    io_reads = get_io_reads(
        bam_reads, pod5_dr,
        reverse_signal=reverse_signal,
        pa_scaling=pa_scaling,
        missing_ok=missing_ok,
    )
    _maybe_refine(
        io_reads, sig_map_refiner, skip_sig_map_refine, require_loaded=True
    )
    per_read = [
        rd.compute_per_base_metric(
            metric, signal_type=signal_type, region=ref_reg, **kwargs
        )
        for rd in io_reads
    ]
    if not per_read:
        return None
    stacked = {
        name: np.stack([read_metrics[name] for read_metrics in per_read])
        for name in per_read[0]
    }
    if ref_orient and ref_reg.strand == "-":
        stacked = {name: vals[:, ::-1] for name, vals in stacked.items()}
    return stacked


def get_ref_reg_samples_metrics(
    ref_reg,
    pod5_bam_pairs,
    *,
    metric="dwell_trimmean",
    max_reads=None,
    sig_map_refiner=None,
    skip_sig_map_refine=False,
    reverse_signal=False,
    missing_ok=False,
    **kwargs,
):
    """get_ref_reg_sample_metrics over every (pod5, bam) sample pair."""
    sampled_bam_reads = []
    per_sample_metrics = []
    for pod5_dr, bam in pod5_bam_pairs:
        sample_reads = _sample_region_reads(ref_reg, bam, max_reads)
        sampled_bam_reads.append(sample_reads)
        sample_metrics = get_ref_reg_sample_metrics(
            ref_reg,
            pod5_dr,
            sample_reads,
            metric,
            sig_map_refiner,
            skip_sig_map_refine=skip_sig_map_refine,
            reverse_signal=reverse_signal,
            missing_ok=missing_ok,
            **kwargs,
        )
        if sample_metrics is not None:
            per_sample_metrics.append(sample_metrics)
    return per_sample_metrics, sampled_bam_reads
