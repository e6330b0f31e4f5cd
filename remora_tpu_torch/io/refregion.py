"""Reference regions and BED parsing (reference analog ``src/remora/io.py:45–144``).

Copy of ``remora_tpu/io/refregion.py``, importing this package's modules.
"""

import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Optional

from remora_tpu_torch import RemoraError

# "ctg:start-end" with an optional ":+"/":-" strand suffix; samtools-style
# 1-based inclusive coordinates
_REGION_RE = re.compile(
    r"(?P<ctg>.+):(?P<start>\d+)-(?P<end>\d+)(?::(?P<strand>[+-]))?$"
)


@dataclass
class RefRegion:
    ctg: "str"
    strand: "str"
    start: "int"
    end: Optional["int"] = None

    @property
    def len(self):
        if self.end is None:
            return 1
        return self.end - self.start

    @property
    def coord_range(self):
        return range(self.start, self.end)

    def clamp(self, lo, hi):
        """Intersect a [lo, hi) span with this region's bounds."""
        return max(lo, self.start), min(hi, self.end)

    @classmethod
    def parse_ref_region_str(cls, ref_reg_str, req_strand=True):
        hit = _REGION_RE.match(ref_reg_str)
        if hit is None or (req_strand and hit["strand"] is None):
            raise RemoraError(f"Invalid reference region: {ref_reg_str}")
        one_based_start = int(hit["start"])
        if one_based_start < 1:
            raise RemoraError("Reference region start must be >= 1")
        return cls(
            hit["ctg"], hit["strand"], one_based_start - 1, int(hit["end"])
        )

    def adjust(self, start_adjust=0, end_adjust=0, *, ref_orient=True):
        """Expanded/shifted copy.

        With ``ref_orient=False`` the adjustments are applied in read
        orientation, so on the reverse strand the start/end roles swap.
        """
        if not ref_orient and self.strand == "-":
            start_adjust, end_adjust = -end_adjust, -start_adjust
        new_end = None if self.end is None else self.end + end_adjust
        return RefRegion(
            ctg=self.ctg,
            strand=self.strand,
            start=self.start + start_adjust,
            end=new_end,
        )


def _bed_fields(bed_path):
    """Yield (ctg, start, end, name, strand-or-None) per valid BED line."""
    with open(bed_path) as fh:
        for line in fh:
            fields = line.split()
            if len(fields) < 3:
                continue
            strand = fields[5] if len(fields) >= 6 and fields[5] in "+-" else None
            name = fields[3] if len(fields) >= 4 else None
            yield fields[0], int(fields[1]), int(fields[2]), name, strand


def parse_bed_lines(bed_path):
    for ctg, start, end, _name, strand in _bed_fields(bed_path):
        yield RefRegion(ctg, strand, start, end)


def parse_bed(bed_path):
    """(ctg, strand) -> set of positions covered by the BED file.

    Strandless records count toward both strands.
    """
    covered = defaultdict(set)
    for ctg, start, end, _name, strand in _bed_fields(bed_path):
        for st in ("+", "-") if strand is None else (strand,):
            covered[(ctg, st)].update(range(start, end))
    return dict(covered)


def parse_mods_bed(bed_path):
    """(ctg, strand) -> {pos: mod_name}; also returns the set of mods seen."""
    site_mods = defaultdict(dict)
    all_mods = set()
    for ctg, start, end, mod, strand in _bed_fields(bed_path):
        all_mods.add(mod)
        for st in ("+", "-") if strand is None else (strand,):
            site_mods[(ctg, st)].update((pos, mod) for pos in range(start, end))
    return dict(site_mods), all_mods
