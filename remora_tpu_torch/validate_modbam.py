"""Validate modBAM calls against ground-truth BED files.

Copy of ``remora_tpu/validate_modbam.py`` over this package's BAM
scanner, BED parser and metrics. Reference analog ``src/remora/validate.py:296–594``: per-read MM/ML
probabilities joined to ground-truth sites over aligned pairs, class
balancing, accuracy/filtered-accuracy report. Probability convention
matches the reference: stored ML byte b -> (b + 0.5) / 256, canonical
probability = 1 - sum(mod probabilities).
"""

from collections import defaultdict

import numpy as np

from remora_tpu_torch import RemoraError, log
from remora_tpu_torch.core.seq import revcomp
from remora_tpu_torch.io.bam import FastBamScanner
from remora_tpu_torch.io.refregion import parse_mods_bed
from remora_tpu_torch.train.validate import process_mods_probs

LOGGER = log.get_logger()

_FULL_HEADER = (
    "query_name\tquery_pos\tref_name\tref_pos\tstrand\t"
    "gt_mod_idx\tmod_probs\tref_align\tquery_align\t"
    "within_align\twithin_gt\n"
)


def _mods_on_called_strand(read):
    """Yield (mod_name, per-site values) for basecall-strand mods only."""
    for (_cb, mod_strand, mod_name), values in (read.modified_bases or {}).items():
        # mod_strand 0 = basecall strand; 1 = opposite (duplex) strand
        if mod_strand == (1 if not read.is_reverse else 0):
            continue
        yield str(mod_name), values


def _query_prob_vectors(read, alphabet):
    """Per-query-position probability vector over [canonical, *mods]."""
    site_probs = defaultdict(dict)
    for mod_name, values in _mods_on_called_strand(read):
        if mod_name not in alphabet:
            continue
        for q_pos, ml_byte in values:
            site_probs[q_pos][mod_name] = (ml_byte + 0.5) / 256
    vectors = {}
    for q_pos, by_mod in site_probs.items():
        mod_probs = [by_mod.get(mod, 0) for mod in alphabet[1:]]
        vectors[q_pos] = np.array([1 - sum(by_mod.values())] + mod_probs)
    return vectors


def _alignment_strings(read, pair_walk):
    """Gapped reference and query alignment strings."""
    ref_chars, query_chars = [], []
    for q, _r, b in pair_walk:
        ref_chars.append(b.upper() if b else "-")
        query_chars.append("-" if q is None else read.query_sequence[q])
    return "".join(ref_chars), "".join(query_chars)


def _context_field(align_str, a_idx, nctx, is_reverse):
    lo = max(0, a_idx - nctx)
    window = align_str[lo : a_idx + nctx + 1].rjust(nctx * 2 + 1, "-")
    if is_reverse:
        window = revcomp(window.replace("-", "N")).replace("N", "-")
    return window


def parse_mod_read(read, site_labels, site_spans, alphabet, detail_fh, nctx=5,
                   max_sites=None):
    """Probability vectors + ground-truth labels for one read's sites."""
    strand = "+-"[read.is_reverse]
    site_key = (read.reference_name, strand)
    labels_here = site_labels.get(site_key)
    span_here = site_spans.get(site_key)

    try:
        pair_walk = read.get_aligned_pairs(with_seq=True)
    except (ValueError, KeyError):
        LOGGER.debug(f"{read.query_name}: no MD tag, skipping read")
        return [], []
    if detail_fh is not None:
        r_align, q_align = _alignment_strings(read, pair_walk)

    prob_vectors = _query_prob_vectors(read, alphabet)

    probs, labels = [], []
    prev_q_pos, prev_r_pos = None, None
    for a_idx, (q_pos, r_pos, _b) in enumerate(pair_walk):
        prev_q_pos = q_pos if q_pos is not None else prev_q_pos
        prev_r_pos = r_pos if r_pos is not None else prev_r_pos
        gt_mod = None if labels_here is None else labels_here.get(r_pos)
        called = prob_vectors.get(q_pos)
        if gt_mod is None and called is None:
            continue
        gt_mod_idx = None if gt_mod is None else alphabet.index(gt_mod)
        if detail_fh is not None:
            probs_field = (
                None if called is None else ",".join(map(str, called))
            )
            ref_ctx = _context_field(r_align, a_idx, nctx, read.is_reverse)
            query_ctx = _context_field(q_align, a_idx, nctx, read.is_reverse)
            within_align = prev_q_pos is not None and (
                read.query_alignment_start
                <= prev_q_pos
                < read.query_alignment_end
            )
            within_gt = (
                within_align
                and span_here is not None
                and prev_r_pos is not None
                and span_here[0] <= prev_r_pos <= span_here[1]
            )
            detail_fh.write(
                f"{read.query_name}\t{q_pos}\t{read.reference_name}\t"
                f"{r_pos}\t{strand}\t{gt_mod_idx}\t{probs_field}\t"
                f"{ref_ctx}\t{query_ctx}\t{within_align}\t{within_gt}\n"
            )
        if gt_mod is not None and called is not None:
            labels.append(gt_mod_idx)
            probs.append(called)
    if max_sites is not None and len(labels) > max_sites:
        keep = np.random.choice(len(labels), size=max_sites, replace=False)
        return [probs[i] for i in keep], [labels[i] for i in keep]
    return probs, labels


class _WarnOnce:
    def __init__(self):
        self.seen = set()

    def __call__(self, key, message):
        if key not in self.seen:
            self.seen.add(key)
            LOGGER.warning(message)


def _has_implicit_mod_tags(read):
    """True when any MM item uses the implicit ('.' or bare) tag type:
    unlisted positions then carry an implied canonical call that per-site
    probability extraction does not represent."""
    try:
        mm = read.get_tag("MM")
    except KeyError:
        return False
    for item in mm.rstrip(";").split(";"):
        if not item:
            continue
        head = item.split(",", 1)[0]
        if not head.endswith("?"):
            return True
    return False


def parse_mod_bam(bam_path, site_labels, site_spans, alphabet, detail_fh,
                  context_bases=5, max_sites=None,
                  explicit_mod_tag_used=False):
    probs, labels = [], []
    warn_once = _WarnOnce()
    for read in FastBamScanner(bam_path):
        if read.modified_bases is None:
            continue
        if not explicit_mod_tag_used and _has_implicit_mod_tags(read):
            raise RemoraError(
                "Implicit ('.') modified-base tag types found (e.g. from "
                "all-context models); per-site probabilities would be "
                "invalid. Pass --explicit-mod-tag-used to force "
                "validation anyway."
            )
        usable = False
        for mod_name, _values in _mods_on_called_strand(read):
            if mod_name in alphabet:
                usable = True
            else:
                warn_once(
                    "mod",
                    f"Modified base found in BAM ({mod_name}) not found "
                    "in ground truth. Add with --extra-bases if needed.",
                )
        n_strand_skipped = sum(1 for _ in read.modified_bases) - sum(
            1 for _ in _mods_on_called_strand(read)
        )
        if n_strand_skipped:
            warn_once(
                "strand", "Reverse strand (duplex) mods not supported"
            )
        if not usable:
            continue
        row_probs, row_labels = parse_mod_read(
            read, site_labels, site_spans, alphabet, detail_fh,
            nctx=context_bases, max_sites=max_sites,
        )
        probs.extend(row_probs)
        labels.extend(row_labels)
    if not probs:
        raise RemoraError(
            f"Found no usable modification calls in {bam_path} — check "
            "that BED and reference FASTA contig names agree."
        )
    LOGGER.debug(
        f"{bam_path}: {len(probs)} modified-base calls collected"
    )
    return np.array(probs), np.array(labels)


def _assemble_ground_truth(beds, extra_bases):
    """Parse BEDs once each; derive the validation alphabet.

    Returns per-sample site dicts, per-sample (min, max) site ranges, and
    the alphabet [canonical, *sorted mods]."""
    parsed = {}
    sample_sites, sample_ranges = [], []
    seen_mods = set()
    for bed_path in beds:
        if bed_path not in parsed:
            parsed[bed_path] = parse_mods_bed(bed_path)
        sites, bed_mods = parsed[bed_path]
        sample_sites.append(sites)
        sample_ranges.append(
            {key: (min(positions), max(positions))
             for key, positions in sites.items()}
        )
        seen_mods.update(bed_mods)
    if extra_bases is not None:
        seen_mods.update(extra_bases)
    canonical = seen_mods.intersection("ACGTU")
    if len(canonical) > 1:
        raise RemoraError(f"More than one canonical base found: {canonical}")
    if not canonical:
        raise RemoraError("No canonical bases found in ground truth.")
    alphabet = list(canonical) + sorted(seen_mods - set("ACGTU"))
    return sample_sites, sample_ranges, alphabet


def validate_modbams(
    bams_and_beds,
    full_results_path,
    name,
    pct_filt,
    *,
    seed=None,
    allow_unbalanced=False,
    max_sites_per_read=None,
    extra_bases=None,
    out_file=None,
    explicit_mod_tag_used=False,
):
    if seed is None:
        seed = int(np.random.randint(0, 2**32 - 1))
    LOGGER.debug(f"validate_modbams seed: {seed}")
    np.random.seed(int(seed))

    if full_results_path is None:
        detail_fh = None
    else:
        detail_fh = open(full_results_path, "w", buffering=512)
        detail_fh.write(_FULL_HEADER)

    LOGGER.info("Parsing ground truth BED files")
    bams, beds = zip(*bams_and_beds)
    sample_sites, sample_ranges, alphabet = _assemble_ground_truth(
        beds, extra_bases
    )

    LOGGER.info("Parsing modBAM files")
    sample_probs, sample_labels = [], []
    for bam_path, sites, ranges in zip(bams, sample_sites, sample_ranges):
        probs, labels = parse_mod_bam(
            bam_path, sites, ranges, alphabet, detail_fh,
            max_sites=max_sites_per_read,
            explicit_mod_tag_used=explicit_mod_tag_used,
        )
        sample_probs.append(probs)
        sample_labels.append(labels)
    if detail_fh is not None:
        detail_fh.close()

    LOGGER.info(f"Alphabet used (and order of reported metrics): {alphabet}")
    out_fp = open(out_file, "w") if out_file else None
    ms = process_mods_probs(
        np.vstack(sample_probs),
        np.concatenate(sample_labels),
        allow_unbalanced,
        pct_filt,
        name,
        fp=out_fp,
    )
    if out_fp is not None:
        out_fp.close()
    return ms
