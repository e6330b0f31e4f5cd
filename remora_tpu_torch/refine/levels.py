"""K-mer expected-level tables (copy of ``remora_tpu/refine/levels.py``).

Reference analogs: ``index_from_kmer`` / table loading / dominant-position
detection in ``src/remora/refine_signal_map.py:129–364`` and the Cython
``extract_levels`` (``refine_signal_map_core.pyx:87–100``) — here a
vectorized sliding-window dot product instead of a per-base C loop.
"""

from itertools import product

import numpy as np

from remora_tpu_torch import RemoraError, log

LOGGER = log.get_logger()


def index_from_kmer(kmer, alphabet="ACGT"):
    """Integer encoding of a k-mer string (base-|alphabet| positional)."""
    return sum(
        alphabet.find(base) * (len(alphabet) ** pos)
        for pos, base in enumerate(kmer[::-1])
    )


def extract_levels(int_seq, levels_array, kmer_len, center_idx):
    """Expected level per base (0 outside full-kmer windows).

    Vectorized: windows are encoded with a stride dot against powers of 4.
    """
    int_seq = np.asarray(int_seq, dtype=np.int64)
    levels = np.zeros(int_seq.size, dtype=np.float32)
    nwin = int_seq.size - kmer_len + 1
    if nwin <= 0:
        return levels
    powers = 4 ** np.arange(kmer_len - 1, -1, -1, dtype=np.int64)
    windows = np.lib.stride_tricks.sliding_window_view(int_seq, kmer_len)
    kmer_idx = windows @ powers
    levels[center_idx : center_idx + nwin] = levels_array[kmer_idx]
    return levels


def load_kmer_table(path):
    """Parse a whitespace kmer<TAB>level table; returns dict kmer->level."""
    str_kmer_levels = {}
    kmer_len = None
    with open(path) as fh:
        for line in fh:
            fields = line.split()
            if not fields:
                continue
            kmer, level = fields[0], fields[1]
            kmer = kmer.upper()
            if kmer_len is None:
                kmer_len = len(kmer)
            if kmer in str_kmer_levels:
                raise RemoraError(f"K-mer found twice in levels file '{kmer}'.")
            if len(kmer) != kmer_len:
                raise RemoraError(
                    f"K-mer lengths not all equal '{len(kmer)} != {kmer_len}' "
                    f"for {kmer}."
                )
            try:
                val = float(level)
            except ValueError:
                raise RemoraError(f"Could not convert level to float '{level}'")
            str_kmer_levels[kmer] = 0.0 if np.isnan(val) else val
    if kmer_len is None or len(str_kmer_levels) != 4**kmer_len:
        raise RemoraError(
            f"K-mer table contains fewer entries ({len(str_kmer_levels)}) "
            f"than expected ({4 ** (kmer_len or 0)})"
        )
    return str_kmer_levels, kmer_len


def levels_dict_to_array(str_kmer_levels, kmer_len):
    arr = np.empty(4**kmer_len, dtype=np.float32)
    for kmer, level in str_kmer_levels.items():
        arr[index_from_kmer(kmer)] = level
    return arr


def determine_dominant_pos(str_kmer_levels, kmer_len):
    """Kruskal–Wallis H per kmer index; the max-H position is the center.

    Returns (center_idx, per-index H statistics).
    """
    from scipy import stats

    sorted_kmers = sorted((lvl, kmer) for kmer, lvl in str_kmer_levels.items())
    kmer_idx_stats = []
    for kmer_idx in range(kmer_len):
        groups = [
            [
                rank
                for rank, (_lvl, kmer) in enumerate(sorted_kmers)
                if kmer[kmer_idx] == base
            ]
            for base in "ACGT"
        ]
        kmer_idx_stats.append(stats.kruskal(*groups)[0])
    center_idx = int(np.argmax(kmer_idx_stats))
    LOGGER.debug(f"Chosen central position: {center_idx}")
    return center_idx, kmer_idx_stats


def fix_gauge(levels_array):
    """Median/MAD normalize a levels array (MAD scaled to SD)."""
    med = np.median(levels_array)
    mad = np.median(np.absolute(levels_array - med)) * 1.4826
    return (levels_array - med) / mad


def all_kmers(kmer_len):
    for kmer in product("ACGT", repeat=kmer_len):
        yield "".join(kmer)
