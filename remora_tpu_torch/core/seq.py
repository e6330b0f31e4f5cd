"""Nucleotide encoding and IUPAC motifs (copy of the parts of
``remora_tpu/core/seq.py`` that the dataset, its metadata, reads, chunk
extraction, the BAM readers and the inference driver use).

Integer base encoding A=0 C=1 G=2 T=3 (other = -1); every IUPAC code is
a 4-bit mask over ACGT, so superset tests and merge-exactness reduce to
bitwise operations and popcount products over those masks.
"""

import math
import re
from dataclasses import dataclass
from itertools import product

import numpy as np

from remora_tpu_torch import RemoraError

CAN_ALPHABET = "ACGT"
CONV_ALPHABET = "ACGTN"

# bit i of a mask <=> CAN_ALPHABET[i] is allowed
_CODE_MASK = {
    "A": 0b0001, "C": 0b0010, "G": 0b0100, "T": 0b1000,
    "M": 0b0011, "R": 0b0101, "W": 0b1001, "S": 0b0110,
    "Y": 0b1010, "K": 0b1100, "V": 0b0111, "H": 0b1011,
    "D": 0b1101, "B": 0b1110, "N": 0b1111,
}
_MASK_CODE = {m: c for c, m in _CODE_MASK.items()}


def _mask_bases(mask):
    """Allowed canonical bases of a 4-bit mask, in alphabet order."""
    return "".join(b for i, b in enumerate(CAN_ALPHABET) if mask >> i & 1)


SINGLE_LETTER_CODE = {c: _mask_bases(m) for c, m in _CODE_MASK.items()}

# 256-entry lookup: ASCII byte -> integer base code (or -1)
_BYTE_TO_INT = np.full(256, -1, dtype=np.int8)
for _i, _b in enumerate(CAN_ALPHABET):
    _BYTE_TO_INT[ord(_b)] = _i
    _BYTE_TO_INT[ord(_b.lower())] = _i

_COMP_TABLE = str.maketrans("ACGTBVDHKMRYacgtbvdhkmry", "TGCAVBHDMKYRtgcavbhdmkyr")
_U_TO_T = str.maketrans("Uu", "Tt")
_T_TO_U = str.maketrans("Tt", "Uu")

# integer complement (canonical bases only): A<->T, C<->G
INT_COMP = np.arange(3, -1, -1)


def seq_to_int(seq):
    """Encode string sequence as int8 array (A=0 C=1 G=2 T=3, other=-1)."""
    return _BYTE_TO_INT[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def int_to_seq(int_seq, alphabet=CONV_ALPHABET):
    """Decode integer array to string sequence; -1 maps to final alphabet
    char."""
    int_seq = np.asarray(int_seq)
    if int_seq.size == 0:
        return ""
    hi = int(int_seq.max())
    if hi >= len(alphabet):
        raise RemoraError(f"Invalid value in int sequence ({hi})")
    lut = np.frombuffer(alphabet.encode("ascii"), dtype=np.uint8)
    return lut[int_seq].tobytes().decode("ascii")


def comp(seq):
    return seq.translate(_COMP_TABLE)


def revcomp(seq):
    return seq.upper().translate(_COMP_TABLE)[::-1]


def comp_int(int_seq):
    return INT_COMP[int_seq]


def revcomp_int(int_seq):
    return comp_int(int_seq)[::-1]


def u_to_t(seq):
    return seq.translate(_U_TO_T)


def t_to_u(seq):
    return seq.translate(_T_TO_U)


def _int_seq_masks(int_seq):
    """Per-position base masks for an integer sequence (-1 -> 0, no match)."""
    int_seq = np.asarray(int_seq)
    masks = np.zeros(int_seq.size, dtype=np.uint8)
    valid = int_seq >= 0
    masks[valid] = np.left_shift(1, int_seq[valid].astype(np.uint8))
    return masks


@dataclass
class Motif:
    """IUPAC sequence motif with a 0-based focus position."""

    raw_motif: str
    focus_pos: int = 0

    def __post_init__(self):
        if not isinstance(self.raw_motif, str):
            raise RemoraError("Motif sequence must be a string")
        unknown = set(self.raw_motif) - set(_CODE_MASK)
        if unknown:
            raise RemoraError(f"Motif contains invalid characters: {unknown}")
        try:
            self.focus_pos = int(self.focus_pos)
        except ValueError:
            raise RemoraError(
                f'Motif focus position not an integer: "{self.focus_pos}"'
            )
        if self.focus_pos >= len(self.raw_motif):
            raise RemoraError(
                "Motif focus position is past the end of the motif"
            )
        # uninformative flanking Ns carry no constraint; drop them
        core_st, core_en = 0, len(self.raw_motif)
        while core_en - core_st > 1 and self.raw_motif[core_st] == "N":
            core_st += 1
        while core_en - core_st > 1 and self.raw_motif[core_en - 1] == "N":
            core_en -= 1
        self.raw_motif = self.raw_motif[core_st:core_en]
        self.focus_pos -= core_st

    @property
    def masks(self):
        """Per-position 4-bit allowed-base masks (numpy uint8)."""
        return np.fromiter(
            (_CODE_MASK[c] for c in self.raw_motif),
            dtype=np.uint8,
            count=len(self.raw_motif),
        )

    def to_tuple(self):
        return self.raw_motif, self.focus_pos

    def __hash__(self):
        return hash((self.raw_motif, self.focus_pos))

    def __len__(self):
        return len(self.raw_motif)

    @property
    def focus_base(self):
        return self.raw_motif[self.focus_pos]

    @property
    def num_bases_after_focus(self):
        return len(self) - 1 - self.focus_pos

    @property
    def pattern(self):
        # wrapped in a lookahead so overlapping occurrences are all found
        body = "".join(f"[{SINGLE_LETTER_CODE[c]}]" for c in self.raw_motif)
        return re.compile(f"(?=({body}))")

    @property
    def int_pattern(self):
        """Allowed integer bases per motif position (list of arrays)."""
        return [
            np.flatnonzero([m >> i & 1 for i in range(4)])
            for m in self.masks
        ]

    @property
    def possible_kmers(self):
        per_pos = [SINGLE_LETTER_CODE[c] for c in self.raw_motif]
        return ["".join(kmer) for kmer in product(*per_pos)]

    def findall(self, int_seq):
        """Start positions of every (possibly overlapping) motif hit, as a
        bitwise-AND reduction of shifted mask views; add ``focus_pos`` to
        convert to focus coordinates."""
        mlen = len(self.raw_motif)
        n_win = np.asarray(int_seq).size - mlen + 1
        if n_win <= 0:
            return np.empty(0, dtype=np.int64)
        seq_masks = _int_seq_masks(int_seq)
        ok = np.ones(n_win, dtype=bool)
        for off, pos_mask in enumerate(self.masks):
            ok &= (seq_masks[off : off + n_win] & pos_mask) != 0
        return np.flatnonzero(ok)

    def match(self, int_seq, pos):
        """Does the motif match with its focus at position ``pos``? Motif
        positions that fall off either end of the sequence match."""
        int_seq = np.asarray(int_seq)
        masks = self.masks
        lo = pos - self.focus_pos
        hi = lo + masks.size
        if lo < 0:
            masks = masks[-lo:]
            lo = 0
        if hi > int_seq.size:
            masks = masks[: masks.size - (hi - int_seq.size)]
            hi = int_seq.size
        window = _int_seq_masks(int_seq[lo:hi])
        return bool(((window & masks) != 0).all())

    def is_super_set(self, other):
        """Are all sequences matched by ``other`` also matched by self?"""
        if self.focus_pos > other.focus_pos:
            return False
        if self.num_bases_after_focus > other.num_bases_after_focus:
            return False
        lo = other.focus_pos - self.focus_pos
        inner = other.masks[lo: lo + len(self.raw_motif)]
        return bool((inner & ~self.masks == 0).all())

    def merge(self, other):
        """Merge with another motif when the union is expressible as one
        motif: the per-position mask union matches exactly |A| + |B| -
        |A∩B| k-mers iff its k-mer count equals that sum."""
        if self == other or self.is_super_set(other):
            return self
        if other.is_super_set(self):
            return other
        if (len(self), self.focus_pos) != (len(other), other.focus_pos):
            raise RemoraError(
                "Only equal-length, focus-aligned motifs can be merged"
            )
        a, b = self.masks, other.masks
        union = a | b
        popcount = np.unpackbits(
            np.stack([a, b, a & b, union]), axis=-1, bitorder="little"
        ).reshape(4, -1, 8).sum(-1)
        n_a, n_b, n_both, n_union = (
            math.prod(int(x) for x in row) for row in popcount
        )
        if n_union != n_a + n_b - n_both:
            raise RemoraError(f"Cannot merge motifs {self} {other}")
        return Motif(
            "".join(_MASK_CODE[int(m)] for m in union), self.focus_pos
        )


def merge_motifs(motifs):
    """Pairwise-merge closure over a list of motifs (or (seq, off) tuples)."""
    pool = list({m if isinstance(m, Motif) else Motif(*m) for m in motifs})
    merged_any = True
    while merged_any and len(pool) > 1:
        merged_any = False
        for i in range(len(pool)):
            for j in range(i + 1, len(pool)):
                try:
                    joined = pool[i].merge(pool[j])
                except RemoraError:
                    continue
                pool = [m for k, m in enumerate(pool) if k not in (i, j)]
                pool.append(joined)
                merged_any = True
                break
            if merged_any:
                break
    return pool


def find_focus_bases(int_seq, motifs):
    """Positions of any-motif focus hits within an integer sequence, in
    set order (unsorted, deduplicated), as the JAX package returns them."""
    return np.fromiter(
        set(
            int(pos) + mot.focus_pos
            for mot in motifs
            for pos in mot.findall(int_seq)
        ),
        dtype=np.int64,
    )


def get_can_converter(alphabet, collapse_alphabet):
    """Map full-alphabet integer codes to canonical-alphabet integer codes."""
    canonical = [cb for mb, cb in zip(alphabet, collapse_alphabet) if mb == cb]
    lut = [canonical.index(cb) if cb in canonical else -1
           for cb in collapse_alphabet]
    return np.array(lut, dtype=np.int8)


def get_mod_bases(alphabet, collapse_alphabet):
    return [mb for mb, cb in zip(alphabet, collapse_alphabet) if mb != cb]


def validate_mod_bases(mod_bases, motifs, alphabet, collapse_alphabet,
                       control=False):
    """Check mutual consistency; return label conversion (alphabet idx ->
    class). Class 0 is the canonical focus base; classes 1..n are
    mod_bases in order; every other alphabet member maps to -1."""
    if len(mod_bases) != len(set(mod_bases)):
        raise RemoraError("Single letter modified base codes must be unique.")
    focus_bases = {mot.focus_base for mot in motifs}
    if len(focus_bases) != 1:
        raise RemoraError(
            "All motifs must be alternatives to the same canonical base"
        )
    (can_base,) = focus_bases
    label_conv = np.full(len(alphabet), -1, dtype=np.int8)
    label_conv[alphabet.find(can_base)] = 0
    if control:
        return label_conv
    for cls, mod_base in enumerate(mod_bases, start=1):
        mod_idx = alphabet.find(mod_base)
        if mod_idx == -1:
            raise RemoraError("Modified base provided not found in alphabet")
        equiv = collapse_alphabet[mod_idx]
        if equiv != can_base:
            raise RemoraError(
                f"Motif canonical base ({can_base}) differs from the "
                f"canonical equivalent of modified base {mod_base} ({equiv})"
            )
        label_conv[mod_idx] = cls
    return label_conv
