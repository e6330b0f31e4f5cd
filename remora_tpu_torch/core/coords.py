"""Alignment coordinate transforms: CIGAR -> ref/query knots -> signal.

Behavioral parity with the reference (``src/remora/data_chunks.py:29–122``):
each reference position receives a fractional query coordinate by linear
interpolation through the endpoints of aligned (match) runs, and that is
then composed with the move-table query->signal map and floored to integer
signal indices.

Copy of ``remora_tpu/core/coords.py``, importing this package's modules.
"""

import re

import numpy as np

from remora_tpu_torch import RemoraError

# Numeric CIGAR op codes follow the SAM spec ordering.
CIGAR_CODES = "MIDNSHP=X"
CODE_TO_OP = {c: i for i, c in enumerate(CIGAR_CODES)}
# Which coordinate systems each op advances, derived from the spec.
REF_OPS = np.array([c in "MDN=X" for c in CIGAR_CODES])
QUERY_OPS = np.array([c in "MIS=X" for c in CIGAR_CODES])
MATCH_OPS = np.array([c in "M=X" for c in CIGAR_CODES])
MATCH_OPS_SET = frozenset(i for i, c in enumerate(CIGAR_CODES) if c in "M=X")

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def cigartuples_from_string(cigarstring):
    """Parse a CIGAR string into a pysam-style list of (op, length)."""
    return [
        (CODE_TO_OP[op], int(count))
        for count, op in _CIGAR_RE.findall(cigarstring)
    ]


def cigartuples_to_string(cigartuples):
    return "".join(f"{ln}{CIGAR_CODES[op]}" for op, ln in cigartuples)


def make_sequence_coordinate_mapping(cigar):
    """Assign a (fractional) query coordinate to every reference position.

    Knots are placed at the first and last base of every aligned run; query
    coordinates for reference positions between runs (deletions/skips) are
    linearly interpolated between the surrounding knots.

    Args:
        cigar: list of (op, length) tuples

    Returns:
        float array of shape (ref_len + 1,)
    """
    # ignore trailing clip/indel ops so the final knot lands on a match
    n_keep = len(cigar)
    while n_keep and cigar[n_keep - 1][0] not in MATCH_OPS_SET:
        n_keep -= 1
    if n_keep == 0:
        raise RemoraError("No match operations found in alignment cigar")
    ops = np.fromiter((op for op, _ in cigar[:n_keep]), dtype=np.int64)
    lens = np.fromiter((ln for _, ln in cigar[:n_keep]), dtype=np.int64)
    if not ((0 <= ops) & (ops <= 8)).all():
        raise RemoraError("Invalid cigar op(s)")
    if (lens < 0).any():
        raise RemoraError("Cigar lengths may not be negative")

    # cumulative end coordinate of every op in each coordinate system
    ref_end = np.cumsum(lens * REF_OPS[ops])
    query_end = np.cumsum(lens * QUERY_OPS[ops])

    aligned = MATCH_OPS[ops]
    run_len = lens[aligned]

    def knot_coords(ends):
        run_end = ends[aligned]
        # two knots per aligned run: run start, and last base of the run
        inner = np.column_stack((run_end - run_len, run_end - 1)).ravel()
        return np.concatenate(([0], inner, ends[-1:]))

    ref_knots = knot_coords(ref_end)
    query_knots = knot_coords(query_end)
    return np.interp(np.arange(ref_knots[-1] + 1), ref_knots, query_knots)


def map_ref_to_signal(*, query_to_signal, ref_to_query_knots):
    """Compose ref->query knots with the query->signal map (floored)."""
    base_idx = np.arange(query_to_signal.size)
    sig_coords = np.interp(ref_to_query_knots, base_idx, query_to_signal)
    return np.floor(sig_coords).astype(int)


def compute_ref_to_signal(query_to_signal, cigar):
    """Reference-position -> signal-index mapping for an aligned read."""
    knots = make_sequence_coordinate_mapping(cigar)
    return map_ref_to_signal(
        query_to_signal=query_to_signal, ref_to_query_knots=knots
    )


def parse_move_table(stride, moves, sig_len, seq_len=None, check=True,
                     reverse_signal=False):
    """Convert a basecaller move table to a query->signal mapping.

    Args:
        stride: basecall model stride
        moves: 0/1 array, one entry per stride of signal
        sig_len: total signal length
        seq_len: expected basecall length (for validation)
        reverse_signal: flip mapping for 3'->5' (RNA) signal
        check: validate table consistency against seq_len / sig_len

    Returns:
        int array of length (num_bases + 1): signal start index per base,
        terminated by sig_len.
    """
    moves = np.asarray(moves)
    base_starts = np.flatnonzero(moves) * stride
    query_to_signal = np.append(base_starts, sig_len)
    if reverse_signal:
        query_to_signal = sig_len - query_to_signal[::-1]
    if check and seq_len is not None and query_to_signal.size - 1 != seq_len:
        raise RemoraError("Move table discordant with basecalls")
    if check and moves.size != sig_len // stride:
        raise RemoraError("Move table discordant with signal")
    return query_to_signal
