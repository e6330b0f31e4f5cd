"""Signal plotting at reference regions (matplotlib backend).

Copy of ``remora_tpu/analyze/plot.py`` over this package's modules.

Reference analog: the plotnine plots in ``src/remora/io.py:1052–1738``
(`plot_signal_at_ref_region` and per-read signal plots) and the
``analyze plot ref_region`` CLI (``parsers.py:1971–2145``).
"""

import numpy as np

from remora_tpu_torch import RemoraError, log
from remora_tpu_torch.analyze.regions import (
    RegionIndexedBam,
    get_reads_reference_regions,
    get_ref_seq_and_levels_from_reads,
)
from remora_tpu_torch.io.pod5 import DatasetReader
from remora_tpu_torch.io.refregion import RefRegion, parse_bed

LOGGER = log.get_logger()

BASE_COLORS = {
    "A": "#00CC00",
    "C": "#0000CC",
    "G": "#FFB300",
    "T": "#CC0000",
    "U": "#CC0000",
    "N": "#FFFFFF",
}
SAMPLE_COLORS = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#8c564b"]


def compute_base_space_sig_coords(seq_to_sig_map):
    """Interpolate signal-point coordinates into base space."""
    return np.interp(
        np.arange(seq_to_sig_map[-1] - seq_to_sig_map[0]),
        seq_to_sig_map,
        np.arange(seq_to_sig_map.size),
    )


def plot_signal_at_ref_region(
    pod5_and_bams,
    ref_reg_str,
    out_path,
    sig_map_refiner=None,
    max_reads=50,
    highlight_positions=None,
    highlight_color="yellow",
    levels_table=None,
    figsize=(18, 5),
):
    """Overlay per-read signal from one or more samples at a region.

    Args:
        pod5_and_bams: list of (pod5_path, bam_path) pairs (samples)
        ref_reg_str: e.g. "chr1:100-200:+"
        out_path: figure path (svg/png/pdf by extension)
    """
    ref_reg = RefRegion.parse_ref_region_str(ref_reg_str)
    pairs = [
        (DatasetReader(pod5_path), RegionIndexedBam(bam_path))
        for pod5_path, bam_path in pod5_and_bams
    ]
    samples_regs, all_bam_reads = get_reads_reference_regions(
        ref_reg,
        pairs,
        sig_map_refiner=sig_map_refiner,
        max_reads=max_reads,
    )
    seq, levels = get_ref_seq_and_levels_from_reads(
        ref_reg, [r for br in all_bam_reads for r in br], sig_map_refiner
    )
    return plot_ref_region_reads(
        ref_reg,
        samples_regs,
        seq,
        levels,
        out_path=out_path,
        highlight_positions=highlight_positions,
        highlight_color=highlight_color,
        figsize=figsize,
    )


def plot_ref_regions_bed(
    pod5_and_bams,
    ref_regions_bed,
    plots_filename,
    sig_map_refiner=None,
    max_reads=50,
    highlight_ranges=None,
    highlight_color="orange",
    figsize=(18, 5),
):
    """Multi-page PDF: one page per BED record (reference
    ``analyze plot ref_region`` surface, parsers.py:2005-2093).
    Strandless records default to the forward strand. POD5/BAM readers
    are opened ONCE and reused across pages — region-indexing the BAM
    is a full scan, so per-page reopening would multiply runtime by the
    number of records."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib.backends.backend_pdf import PdfPages

    from remora_tpu_torch.io.refregion import parse_bed_lines

    regions = list(parse_bed_lines(ref_regions_bed))
    if not regions:
        raise RemoraError(f"No regions parsed from {ref_regions_bed}")
    import matplotlib.pyplot as plt

    pairs = [
        (DatasetReader(pod5_path), RegionIndexedBam(bam_path))
        for pod5_path, bam_path in pod5_and_bams
    ]
    with PdfPages(plots_filename) as pdf:
        for reg in regions:
            if reg.strand is None:
                reg = RefRegion(reg.ctg, "+", reg.start, reg.end)
            samples_regs, all_bam_reads = get_reads_reference_regions(
                reg,
                pairs,
                sig_map_refiner=sig_map_refiner,
                max_reads=max_reads,
            )
            seq, levels = get_ref_seq_and_levels_from_reads(
                reg,
                [r for br in all_bam_reads for r in br],
                sig_map_refiner,
            )
            fig = plot_ref_region_reads(
                reg,
                samples_regs,
                seq,
                levels,
                out_path=None,
                highlight_positions=highlight_ranges,
                highlight_color=highlight_color,
                figsize=figsize,
            )
            pdf.savefig(fig)
            plt.close(fig)
    LOGGER.info(f"Region plots written to {plots_filename}")
    return plots_filename


def plot_ref_region_reads(
    ref_reg,
    samples_read_ref_regs,
    seq,
    levels,
    out_path=None,
    sample_names=None,
    highlight_positions=None,
    highlight_color="yellow",
    figsize=(18, 5),
):
    """Plot already-extracted read signals over a reference region
    (reference analog ``io.plot_ref_region_reads`` io.py:1421–1569;
    fetch with ``analyze.regions.get_reads_reference_regions``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=figsize)
    if sample_names is None:
        sample_names = [
            f"Sample{i + 1}" for i in range(len(samples_read_ref_regs))
        ]
    for samp_i, sample_regs in enumerate(samples_read_ref_regs):
        color = SAMPLE_COLORS[samp_i % len(SAMPLE_COLORS)]
        first = True
        for read_reg in sample_regs:
            coords = (
                compute_base_space_sig_coords(read_reg.seq_to_sig_map)
                + ref_reg.start
            )
            ax.plot(
                coords,
                read_reg.norm_signal,
                color=color,
                alpha=0.25,
                lw=0.7,
                label=sample_names[samp_i] if first else None,
            )
            first = False
    # base backgrounds
    for pos, base in zip(range(ref_reg.start, ref_reg.end), seq):
        ax.axvspan(
            pos,
            pos + 1,
            color=BASE_COLORS.get(base, "#FFFFFF"),
            alpha=0.08,
        )
        ax.text(
            pos + 0.5,
            ax.get_ylim()[0],
            base,
            ha="center",
            va="bottom",
            fontsize=7,
            color=BASE_COLORS.get(base, "#000000"),
        )
    if levels is not None and np.isfinite(levels).any():
        for pos, level in zip(range(ref_reg.start, ref_reg.end), levels):
            if np.isfinite(level):
                ax.hlines(level, pos, pos + 1, colors="black", lw=1.5)
    if highlight_positions is not None:
        hl = parse_bed(highlight_positions)
        for pos in hl.get((ref_reg.ctg, ref_reg.strand), ()):
            if ref_reg.start <= pos < ref_reg.end:
                ax.axvspan(pos, pos + 1, color=highlight_color, alpha=0.3)
    ax.set_xlim(ref_reg.start, ref_reg.end)
    ax.set_xlabel(f"{ref_reg.ctg} ({ref_reg.strand})")
    ax.set_ylabel("Normalized signal")
    if len(samples_read_ref_regs) > 1:
        ax.legend(loc="upper right")
    fig.tight_layout()
    if out_path is None:
        return fig
    fig.savefig(out_path)
    plt.close(fig)
    LOGGER.info(f"Region plot written to {out_path}")
    return out_path


def plot_on_signal_coords(seq, norm_signal, seq_to_sig_map, out_path=None,
                          rev_strand=False, sig_start=0, figsize=(18, 5)):
    """Single-read signal vs signal coordinates with base spans."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=figsize)
    x = np.arange(norm_signal.size) + sig_start
    ax.plot(x, norm_signal, color="black", lw=0.8)
    for bi, base in enumerate(seq):
        st = seq_to_sig_map[bi] + sig_start
        en = seq_to_sig_map[bi + 1] + sig_start
        ax.axvspan(st, en, color=BASE_COLORS.get(base, "#FFFFFF"), alpha=0.1)
    ax.set_xlabel("Signal position")
    ax.set_ylabel("Normalized signal")
    fig.tight_layout()
    if out_path is not None:
        fig.savefig(out_path)
        plt.close(fig)
        return out_path
    return fig


def plot_on_base_coords(seq, norm_signal, seq_to_sig_map, out_path=None,
                        start_base=0, rev_strand=False,
                        xlab="Base position", figsize=(18, 5)):
    """Single-read signal vs base coordinates."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=figsize)
    coords = compute_base_space_sig_coords(seq_to_sig_map) + start_base
    ax.plot(coords, norm_signal, color="black", lw=0.8)
    for bi, base in enumerate(seq):
        ax.axvspan(
            start_base + bi,
            start_base + bi + 1,
            color=BASE_COLORS.get(base, "#FFFFFF"),
            alpha=0.1,
        )
    ax.set_xlabel(xlab)
    ax.set_ylabel("Normalized signal")
    fig.tight_layout()
    if out_path is not None:
        fig.savefig(out_path)
        plt.close(fig)
        return out_path
    return fig


def plot_ref_region_metrics(samples_metrics, ref_reg, out_path,
                            sample_names=None, figsize=(18, 8)):
    """Boxplots of per-base metrics across samples (metric_boxplots analog)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if not samples_metrics:
        raise RemoraError("No metrics to plot")
    metric_names = list(samples_metrics[0].keys())
    fig, axes = plt.subplots(
        len(metric_names), 1, figsize=figsize, sharex=True
    )
    if len(metric_names) == 1:
        axes = [axes]
    positions = np.arange(ref_reg.start, ref_reg.end)
    for ax, mname in zip(axes, metric_names):
        for samp_i, sm in enumerate(samples_metrics):
            vals = sm[mname]
            med = np.nanmedian(vals, axis=0)
            q1 = np.nanpercentile(vals, 25, axis=0)
            q3 = np.nanpercentile(vals, 75, axis=0)
            color = SAMPLE_COLORS[samp_i % len(SAMPLE_COLORS)]
            ax.plot(positions, med, color=color, lw=1.2)
            ax.fill_between(positions, q1, q3, color=color, alpha=0.2)
        ax.set_ylabel(mname)
    axes[-1].set_xlabel(f"{ref_reg.ctg} ({ref_reg.strand})")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def plot_align(
    io_read,
    sig_st,
    sig_en,
    out_path=None,
    t_as_u=False,
    xlab="Signal Position",
    ylab="Normalized Signal",
    signal_type="norm",
    figsize=(18, 5),
):
    """Single read in signal space with basecall and reference-alignment
    bases annotated (reference analog ``io.plot_align`` io.py:1294–1418).

    Basecall base boundaries are drawn above the trace (from the move
    table), reference bases below (through the CIGAR mapping).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sig = io_read.get_sig_type(signal_type)
    sig_st = max(0, int(sig_st))
    sig_en = min(sig.size, int(sig_en))
    if sig_en <= sig_st:
        raise RemoraError("Empty signal window")
    fig, ax = plt.subplots(figsize=figsize)
    x = np.arange(sig_st, sig_en)
    ax.plot(x, sig[sig_st:sig_en], color="black", lw=0.8)
    lo, hi = ax.get_ylim()

    def _annotate(seq, to_sig, y, va):
        st_b = np.searchsorted(to_sig[:-1], sig_st, side="right") - 1
        en_b = np.searchsorted(to_sig[:-1], sig_en, side="left")
        for bi in range(max(st_b, 0), min(en_b, len(seq))):
            b_st = max(to_sig[bi], sig_st)
            b_en = min(to_sig[bi + 1], sig_en)
            if b_en <= b_st:
                continue
            base = seq[bi]
            if t_as_u and base == "T":
                base = "U"
            ax.axvline(b_st, color="#888888", lw=0.4, alpha=0.5)
            ax.text(
                (b_st + b_en) / 2,
                y,
                base,
                ha="center",
                va=va,
                fontsize=8,
                color=BASE_COLORS.get(base, "#000000"),
            )

    if io_read.seq is not None and io_read.query_to_signal is not None:
        _annotate(io_read.seq, io_read.query_to_signal, hi, "top")
    if io_read.ref_seq is not None and io_read.ref_to_signal is not None:
        _annotate(io_read.ref_seq, io_read.ref_to_signal, lo, "bottom")
    ax.set_xlabel(xlab)
    ax.set_ylabel(ylab)
    fig.tight_layout()
    if out_path is None:
        return fig
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def plot_metric_at_ref_region(
    ref_reg,
    pod5_bam_pairs,
    out_path=None,
    metric="dwell_trimmean",
    sig_map_refiner=None,
    max_reads=None,
    reverse_signal=False,
    sample_names=None,
    figsize=(18, 5),
    **kwargs,
):
    """Per-site distribution of a signal metric across samples at a
    reference region (reference analog ``io.plot_metric_at_ref_region``
    io.py:1692–1738): fetches per-read per-base metrics and draws one
    boxplot per position per sample."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from remora_tpu_torch.analyze.regions import get_ref_reg_samples_metrics

    samples_metrics, _bam_reads = get_ref_reg_samples_metrics(
        ref_reg,
        pod5_bam_pairs,
        sig_map_refiner=sig_map_refiner,
        max_reads=max_reads,
        reverse_signal=reverse_signal,
        metric=metric,
        **kwargs,
    )
    if not samples_metrics:
        raise RemoraError("No metrics to plot")
    metric_names = list(samples_metrics[0].keys())
    if sample_names is None:
        sample_names = [f"Sample{i + 1}" for i in range(len(samples_metrics))]
    fig, axes = plt.subplots(
        len(metric_names), 1, figsize=figsize, sharex=True
    )
    if len(metric_names) == 1:
        axes = [axes]
    nsamp = len(samples_metrics)
    width = 0.8 / nsamp
    for ax, mname in zip(axes, metric_names):
        for samp_i, sm in enumerate(samples_metrics):
            vals = sm[mname]  # (nreads, reg_len)
            color = SAMPLE_COLORS[samp_i % len(SAMPLE_COLORS)]
            positions = (
                np.arange(ref_reg.start, ref_reg.start + vals.shape[1])
                + (samp_i - (nsamp - 1) / 2) * width
            )
            data = [col[np.isfinite(col)] for col in vals.T]
            bp = ax.boxplot(
                data,
                positions=positions,
                widths=width * 0.9,
                patch_artist=True,
                manage_ticks=False,
                flierprops={"markersize": 2},
            )
            for box in bp["boxes"]:
                box.set_facecolor(color)
                box.set_alpha(0.5)
        ax.set_ylabel(mname)
    axes[-1].set_xlabel(f"{ref_reg.ctg} ({ref_reg.strand})")
    handles = [
        plt.Line2D([], [], color=SAMPLE_COLORS[i % len(SAMPLE_COLORS)],
                   lw=4, label=sample_names[i])
        for i in range(nsamp)
    ]
    axes[0].legend(handles=handles, loc="upper right")
    fig.tight_layout()
    if out_path is None:
        return fig
    fig.savefig(out_path)
    plt.close(fig)
    return out_path
