"""Vectorized whole-read chunk extraction (copy of
``remora_tpu/data/chunk_batch.py``).

Produces dataset-format arrays for ALL focus bases of a read in a few
NumPy ops — behaviorally identical to looping ``RemoraRead.iter_chunks``
-> ``extract_chunk`` -> ``CoreDataset.write_chunk`` (parity-tested on
the reference test reads), but without per-chunk Python overhead. Used
by the streaming inference prepare stage where per-read chunk counts
reach hundreds.
"""

import numpy as np

from remora_tpu_torch import log

LOGGER = log.get_logger()


def _motif_hit_mask(int_seq, focus_bases, motifs):
    """Which focus bases match any motif (same clipped-edge semantics as
    ``Motif.match``)."""
    if motifs is None:
        return np.ones(focus_bases.size, dtype=bool)
    mask = np.zeros(focus_bases.size, dtype=bool)
    n = int_seq.size
    for motif in motifs:
        mlen = len(motif.raw_motif)
        interior_hits = motif.findall(int_seq) + motif.focus_pos
        interior = (
            (focus_bases - motif.focus_pos >= 0)
            & (focus_bases + motif.num_bases_after_focus < n)
        )
        mask |= interior & np.isin(focus_bases, interior_hits)
        # edge-clipped positions fall back to the permissive per-site test
        edge_idx = np.where(~interior & ~mask)[0]
        for i in edge_idx:
            if motif.match(int_seq, int(focus_bases[i])):
                mask[i] = True
    return mask


def extract_chunks_batch(
    read,
    chunk_context,
    kmer_context_bases,
    max_seq_len,
    base_start_justify=False,
    offset=0,
    motifs=None,
    check_chunks=False,
    tight=False,
):
    """Extract all chunks of ``read`` as padded dataset-format arrays.

    Returns dict with keys signal (n,1,W) f32, sequence (n, max_seq_len +
    sum(kcb)) i8, sequence_to_signal_mapping (n, max_seq_len+1) i16,
    sequence_lengths (n,) i16, labels (n,) i64, read_focus_bases (n,)
    i64 — or None when no chunks survive. Chunks whose sequence exceeds
    ``max_seq_len`` are dropped (the caller's "Sequence too long" path).

    ``tight=True`` sizes the sequence/mapping rows to the read's actual
    longest surviving chunk instead of ``max_seq_len`` (values are
    identical, trailing pad columns are simply absent). The streaming
    inference prep stage uses this: its batch assembler pastes narrower
    per-read rows into model-wide batches anyway, and at production
    shapes ``max_seq_len`` is ~8x the typical chunk's sequence span, so
    full-width rows were ~8x wasted array work per read (the measured
    2.9 ms/read single-core prep wall, PERF.md round 4). The ETL path
    keeps full width: its arrays land in fixed-width dataset memmaps.
    """
    focus_bases = read.focus_bases
    if focus_bases is None or focus_bases.size == 0:
        return None
    focus_bases = np.asarray(focus_bases, dtype=np.int64)
    keep = _motif_hit_mask(read.int_seq, focus_bases, motifs)
    focus_bases = focus_bases[keep]
    if focus_bases.size == 0:
        return None

    s2s = read.seq_to_sig_map
    sig = read.sig
    sig_len = sig.size
    before, after = chunk_context
    W = before + after
    kb, ka = kmer_context_bases
    kcb = kb + ka

    labels = (
        np.full(focus_bases.size, -1, dtype=np.int64)
        if read.labels is None
        else np.asarray(read.labels)[focus_bases].astype(np.int64)
    )
    fb = np.clip(focus_bases + offset, 0, s2s.size - 2)
    if base_start_justify:
        centers = s2s[fb]
    else:
        centers = (s2s[fb] + s2s[fb + 1]) // 2
    sig_start = centers - before
    sig_end = centers + after

    # signal windows, zero-padded at read edges; only edge-clipped rows
    # (rare: focus bases within chunk_context of a read end) pay the
    # masked-clip path — interior rows are a plain gather, which halves
    # the prep stage's biggest single cost (PERF.md round 4)
    # interior rows index whole windows out of a sliding-window VIEW —
    # one row-wise memcpy per chunk instead of a per-element 2D fancy
    # gather (the latter was ~2/3 of the remaining prep cost at W=400)
    col = np.arange(W, dtype=np.int64)[None, :]
    edge_rows = (sig_start < 0) | (sig_end > sig_len)
    if sig_len >= W and not edge_rows.any():
        win = np.lib.stride_tricks.sliding_window_view(sig, W)
        signal = win[sig_start].astype(np.float32, copy=False)
    else:
        interior = ~edge_rows
        signal = np.empty((focus_bases.size, W), np.float32)
        if interior.any():
            win = np.lib.stride_tricks.sliding_window_view(sig, W)
            signal[interior] = win[sig_start[interior]]
        eidx = sig_start[edge_rows][:, None] + col
        valid = (eidx >= 0) & (eidx < sig_len)
        signal[edge_rows] = np.where(
            valid, sig[np.clip(eidx, 0, sig_len - 1)], 0.0
        )

    # reference parity: edge chunks clamp the window bounds BEFORE the
    # sequence-range searchsorted (extract_chunk's padding branch)
    seq_start = (
        np.searchsorted(s2s, np.maximum(sig_start, 0), side="right") - 1
    )
    seq_end = np.searchsorted(
        s2s, np.minimum(sig_end, sig_len), side="left"
    )
    seq_lens = (seq_end - seq_start).astype(np.int64)

    # drop over-long chunks (caller parity: "Sequence too long")
    ok = seq_lens <= max_seq_len
    n_long = int((~ok).sum())
    if check_chunks:
        # Chunk.check parity: NaN signal rows are skipped (not an error)
        nan_rows = np.isnan(signal).any(axis=1)
        if nan_rows.any():
            LOGGER.debug(f"FAILED_CHUNK_CHECK {int(nan_rows.sum())} NaN rows")
            ok &= ~nan_rows
    if not ok.all():
        (signal, sig_start, seq_start, seq_end, seq_lens, labels, fb,
         focus_bases) = (
            signal[ok], sig_start[ok], seq_start[ok], seq_end[ok],
            seq_lens[ok], labels[ok], fb[ok], focus_bases[ok],
        )
    if seq_lens.size == 0:
        return None
    n = seq_lens.size
    row_len = int(seq_lens.max()) if tight else max_seq_len

    # seq_to_sig mapping rows: s2s[seq_start + j] - sig_start, pinned at
    # 0 / W at the row ends; a sentinel-padded s2s makes the gather
    # clip-free (indices past the read end land in the pad)
    map_w = row_len + 1
    jcol = np.arange(map_w, dtype=np.int64)[None, :]
    map_idx = seq_start[:, None] + jcol
    in_row = jcol <= seq_lens[:, None]
    s2s_pad = np.concatenate([s2s, np.zeros(map_w, s2s.dtype)])
    gathered = s2s_pad[map_idx]
    # chunk-relative, incl. the zero-pad offset at the left read edge
    rel = gathered - sig_start[:, None]
    rel[:, 0] = 0
    rows = np.arange(n)
    rel[rows, seq_lens] = W
    mapping = np.where(in_row, rel, 0).astype(np.int16)

    # sequence rows with kmer context, -1 where outside the read; the
    # int_seq gather indexes a -1-padded copy so out-of-read positions
    # come back -1 without index clipping
    seq_w = row_len + kcb
    scol = np.arange(seq_w, dtype=np.int64)[None, :]
    seq_idx = seq_start[:, None] + scol  # = (seq_start - kb) + scol + kb
    seq_pad = np.full(read.int_seq.size + kb + seq_w, -1, np.int8)
    seq_pad[kb : kb + read.int_seq.size] = read.int_seq
    sequence = np.where(
        scol < (seq_lens + kcb)[:, None], seq_pad[seq_idx], np.int8(-1)
    )
    # parity detail: positions past this chunk's (seq_len + kcb) are
    # uninitialized in the reference write path; -1 there matches the
    # reference edge padding and every consumer masks by seq_len

    if n_long:
        LOGGER.debug(f"dropped {n_long} over-long chunks")
    return {
        "signal": signal[:, None, :],
        "sequence": sequence,
        "sequence_to_signal_mapping": mapping,
        "sequence_lengths": seq_lens.astype(np.int16),
        "labels": labels,
        "read_focus_bases": fb.astype(np.int64),
    }, n_long
