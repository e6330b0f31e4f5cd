"""SAM MM/ML modified-base tag formatting.

Behavioral parity with the reference (``src/remora/util.py:485–537``):
`?`-style skip semantics, delta gaps counted in same-canonical-base
coordinates, ML probabilities scaled as floor(p*256) clipped to 255.
"""

import array
from operator import itemgetter

import numpy as np


def softmax(x, axis=1):
    """Numerically stable softmax along the given axis (float64 internally)."""
    x = np.asarray(x)
    m = np.max(x, axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=axis, keepdims=True)


def format_mm_ml_tags(seq, poss, probs, mod_bases, can_base, strand="+"):
    """Format MM and ML tag contents for one read.

    Args:
        seq: read-oriented sequence string (revcomp for reference-anchored
            reverse-strand calls)
        poss: positions of calls relative to ``seq``
        probs: per-call modified-base probabilities, shape (ncalls, nmods)
            (entries may be None to skip a call)
        mod_bases: modified-base single-letter/ChEBI codes
        can_base: canonical base letter
        strand: "+" for SEQ orientation, "-" for complement strand

    Returns:
        (mm_tag string, ml array.array('B'))
    """
    by_mod = {mb: [] for mb in mod_bases}
    for pos, call_probs in sorted(zip(poss, probs), key=itemgetter(0)):
        if call_probs is None:
            continue
        for mod_base, mod_prob in zip(mod_bases, call_probs):
            by_mod[mod_base].append((pos, mod_prob))

    # rank of every sequence position among same-canonical-base positions
    seq_bytes = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    nth_can_base = np.cumsum(seq_bytes == ord(can_base))

    mm_tag = ""
    ml_tag = array.array("B")
    for mod_base in mod_bases:
        site_calls = by_mod[mod_base]
        if not site_calls:
            continue
        sites, site_probs = zip(*sorted(site_calls))
        ranks = nth_can_base[np.array(sites)] - 1
        # MM delta encoding: canonical bases skipped between calls
        deltas = np.diff(ranks, prepend=-1) - 1
        mm_tag += (
            f"{can_base}{strand}{mod_base}?,"
            + ",".join(map(str, deltas))
            + ";"
        )
        quantized = np.minimum(np.floor(np.array(site_probs) * 256), 255)
        ml_tag.extend(quantized.astype(np.uint8))
    return mm_tag, ml_tag


def mods_tags_to_str(mm_tags, ml_arr):
    """Render MM/ML tag values as SAM text fields."""
    return [
        f"MM:Z:{''.join(mm_tags)}",
        f"ML:B:C,{','.join(map(str, ml_arr))}",
    ]
