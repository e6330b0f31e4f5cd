"""K-mer expected-level estimation from signal + alignments.

Copy of ``remora_tpu/analyze/kmer_levels.py`` over this package's modules.

Reference analog ``io.get_region_kmers``/``get_site_kmer_levels``
(``io.py:930–1044``) and the ``estimate_kmer_levels`` runner
(``parsers.py:2148–2333``): per-site medians of trimmed per-base means
across covering reads, aggregated per k-mer over all covered regions.
"""

from itertools import product

import numpy as np

from remora_tpu_torch import log
from remora_tpu_torch.analyze.regions import (
    get_ref_reg_sample_metrics,
    get_ref_seq_from_reads,
    iter_covered_regions,
)
from remora_tpu_torch.core.pipeline import map_stage
from remora_tpu_torch.io.pod5 import DatasetReader

LOGGER = log.get_logger()


def _prep_pod5_reader(pod5_path, *args, **kwargs):
    """Open the POD5 reader inside each worker (must be module-level so
    it pickles into spawned processes)."""
    return (DatasetReader(pod5_path), *args), kwargs


def get_region_kmers(
    reg_and_bam_reads,
    pod5_dr,
    sig_map_refiner,
    kmer_context_bases,
    min_cov=10,
    start_trim=2,
    end_trim=2,
    reverse_signal=False,
):
    """Per-kmer site-median levels within one region."""
    reg, bam_reads = reg_and_bam_reads
    reg_metrics = get_ref_reg_sample_metrics(
        reg,
        pod5_dr,
        bam_reads,
        "dwell_trimmean",
        sig_map_refiner,
        start_trim=start_trim,
        end_trim=end_trim,
        ref_orient=False,
        reverse_signal=reverse_signal,
    )
    seq = get_ref_seq_from_reads(
        reg.adjust(
            -kmer_context_bases[0], kmer_context_bases[1], ref_orient=False
        ),
        bam_reads,
        ref_orient=False,
    )
    kmer_len = sum(kmer_context_bases) + 1
    reg_kmer_levels = {
        "".join(bs): [] for bs in product("ACGT", repeat=kmer_len)
    }
    if reg_metrics is None:
        return reg_kmer_levels
    for offset in range(reg.len):
        kmer = seq[offset : offset + kmer_len]
        try:
            offset_levels = reg_kmer_levels[kmer]
        except KeyError:
            continue
        site_read_levels = reg_metrics["trimmean"][:, offset]
        site_read_levels = site_read_levels[np.isfinite(site_read_levels)]
        if site_read_levels.size < min_cov:
            continue
        offset_levels.append(float(np.median(site_read_levels)))
    return reg_kmer_levels


def get_site_kmer_levels(
    pod5_path,
    bam_path,
    sig_map_refiner,
    kmer_context_bases,
    min_cov=10,
    chunk_len=1_000,
    max_chunk_cov=100,
    start_trim=1,
    end_trim=1,
    num_workers=1,
    reverse_signal=False,
):
    """All per-site median levels keyed by k-mer across one sample."""
    regs_kmer_levels = map_stage(
        get_region_kmers,
        iter_covered_regions(
            bam_path, chunk_len=chunk_len, max_chunk_cov=max_chunk_cov
        ),
        prep_func=_prep_pod5_reader,
        num_workers=num_workers,
        use_process=True,
        args=(pod5_path, sig_map_refiner, kmer_context_bases),
        kwargs={
            "min_cov": min_cov,
            "start_trim": start_trim,
            "end_trim": end_trim,
            "reverse_signal": reverse_signal,
        },
        name="GetKmers",
    )
    kmer_len = sum(kmer_context_bases) + 1
    all_kmer_levels = {
        "".join(bs): [] for bs in product("ACGT", repeat=kmer_len)
    }
    for reg_kmer_levels in regs_kmer_levels:
        for kmer, levels in reg_kmer_levels.items():
            all_kmer_levels[kmer].extend(levels)
    return {
        kmer: np.asarray(levels) for kmer, levels in all_kmer_levels.items()
    }


def estimate_kmer_levels(
    pod5_and_bams,
    out_path,
    kmer_context_bases=(2, 2),
    min_coverage=10,
    min_kmer_obs=1,
    chunk_len=1_000,
    max_chunk_coverage=100,
    num_workers=1,
    reverse_signal=False,
    sig_map_refiner=None,
):
    """Estimate and write a k-mer level table from one or more samples."""
    samples_levels = []
    for pod5_path, bam_path in pod5_and_bams:
        LOGGER.info(f"Estimating levels from {pod5_path} / {bam_path}")
        samples_levels.append(
            get_site_kmer_levels(
                pod5_path,
                bam_path,
                sig_map_refiner,
                kmer_context_bases,
                min_cov=min_coverage,
                chunk_len=chunk_len,
                max_chunk_cov=max_chunk_coverage,
                num_workers=num_workers,
                reverse_signal=reverse_signal,
            )
        )
    n_missing = 0
    with open(out_path, "w") as fh:
        for kmer in samples_levels[0]:
            levels = np.concatenate([sl[kmer] for sl in samples_levels])
            if levels.size >= min_kmer_obs:
                fh.write(f"{kmer}\t{np.median(levels)}\n")
            else:
                n_missing += 1
                fh.write(f"{kmer}\tnan\n")
    if n_missing:
        LOGGER.warning(
            f"{n_missing} k-mers had fewer than {min_kmer_obs} observations "
            "(written as nan)"
        )
    LOGGER.info(f"K-mer level table written to {out_path}")
