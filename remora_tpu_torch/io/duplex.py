"""Duplex read handling: simplex->duplex re-anchoring + pair building.

Port of ``remora_tpu/io/duplex.py`` (reference analogs:
``src/remora/duplex_utils.py``, parasail alignment + coordinate remap,
and ``io.DuplexRead``/``DuplexPairsBuilder``, ``io.py:2487–2599``). The
pairwise aligner is the host C++ semi-global affine-gap kernel in
``csrc/host/align.cpp`` (parasail replacement), with its NumPy twin when
the host library cannot be built. Host code only: nothing here touches
the GPU, so the driver's forked stages may run it.
"""

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from remora_tpu_torch import RemoraError, log
from remora_tpu_torch.core import coords, seq as sequtil
from remora_tpu_torch.io.native import sg_align_native

LOGGER = log.get_logger()

CigarTuples = List[Tuple[int, int]]


@dataclass
class PairwiseAlignment:
    ref_start: int
    ref_end: int
    query_start: int
    query_end: int
    cigar: CigarTuples


def pairwise_align(*, query, ref, gap_open=10, gap_extend=2):
    """Semi-global alignment with free QUERY end gaps (parasail sg_qx
    semantics, reference ``duplex_utils.py:62–86``): the reference
    sequence is consumed globally while unaligned query prefix/suffix
    bases cost nothing.

    The native kernel implements the mirror problem (free REF
    overhangs, query consumed globally); by score symmetry running it
    with the operands swapped and exchanging I<->D ops and
    query<->ref coordinates yields exactly the sg_qx alignment.

    Returns a PairwiseAlignment whose cigar starts/ends with match ops
    (leading/trailing indels already trimmed into the coordinates).
    """
    cigar, q_start, q_end, r_start, r_end = sg_align_native(
        ref, query, gap_open, gap_extend
    )
    cigar = [(op if op == 0 else 3 - op, ln) for op, ln in cigar]
    if not cigar or cigar[0][0] not in (0, 7, 8):
        raise RuntimeError(
            "failed to find match operations in pairwise alignment"
        )
    return PairwiseAlignment(
        ref_start=r_start,
        ref_end=r_end,
        query_start=q_start,
        query_end=q_end,
        cigar=cigar,
    )


@dataclass
class SimplexDuplexMapping:
    duplex_to_simplex_mapping: np.ndarray
    trimmed_duplex_seq: str
    duplex_offset: int


def map_simplex_to_duplex(*, simplex_seq, duplex_seq):
    """Coordinate mapping from (trimmed) duplex positions to simplex."""
    aln = pairwise_align(query=simplex_seq, ref=duplex_seq)
    trimmed_duplex = duplex_seq[aln.ref_start : aln.ref_end]
    duplex_to_simplex_mapping = (
        coords.make_sequence_coordinate_mapping(aln.cigar).astype(int)
        + aln.query_start
    )
    return SimplexDuplexMapping(
        duplex_to_simplex_mapping=duplex_to_simplex_mapping,
        trimmed_duplex_seq=trimmed_duplex,
        duplex_offset=aln.ref_start,
    )


@dataclass
class DuplexRead:
    duplex_read_id: str
    duplex_alignment: object  # BamRecord
    is_reverse_mapped: bool
    template_read: object
    complement_read: object
    template_ref_start: int
    complement_ref_start: int

    @classmethod
    def from_reads_and_alignment(cls, *, template_read, complement_read,
                                 duplex_alignment):
        is_reverse_mapped = duplex_alignment.is_reverse
        duplex_direction_read, reverse_complement_read = (
            (template_read, complement_read)
            if not is_reverse_mapped
            else (complement_read, template_read)
        )
        (
            template_read,
            template_ref_start,
        ) = duplex_direction_read.with_duplex_alignment(
            duplex_alignment, duplex_orientation=True
        )
        (
            complement_read,
            complement_ref_start,
        ) = reverse_complement_read.with_duplex_alignment(
            duplex_alignment, duplex_orientation=False
        )
        return cls(
            duplex_read_id=duplex_alignment.query_name,
            duplex_alignment=duplex_alignment,
            is_reverse_mapped=is_reverse_mapped,
            template_read=template_read,
            complement_read=complement_read,
            template_ref_start=template_ref_start,
            complement_ref_start=complement_ref_start,
        )

    @property
    def duplex_basecalled_sequence(self):
        # BAM stores SEQ in mapping orientation (reverse-complemented on
        # reverse mappings, matching pysam query_sequence semantics)
        return self.duplex_alignment.query_sequence


class DuplexPairsBuilder:
    """Join (template, complement) read-id pairs with signal + alignments."""

    def __init__(self, simplex_index, pod5_path):
        from remora_tpu_torch.io.pod5 import DatasetReader

        self.simplex_index = simplex_index
        self.pod5_path = pod5_path
        self.reader = DatasetReader(pod5_path)

    def make_read_pair(self, read_id_pair):
        from remora_tpu_torch.io.read import Read

        pod5_reads = list(self.reader.reads(selection=list(read_id_pair)))
        if len(pod5_reads) < 2:
            return None, "duplex pair read id(s) missing from pod5"
        if len(pod5_reads) > 2:
            return None, "pod5 has multiple reads with the same id"
        pod5_reads = {str(r.read_id): r for r in pod5_reads}
        temp_read_id, comp_read_id = read_id_pair
        try:
            temp_align = self.simplex_index.get_first_alignment(temp_read_id)
            comp_align = self.simplex_index.get_first_alignment(comp_read_id)
        except RemoraError:
            return None, "failed to find read in simplex bam"
        temp_io_read = Read.from_pod5_and_alignment(
            pod5_read_record=pod5_reads[temp_read_id],
            alignment_record=temp_align,
        )
        comp_io_read = Read.from_pod5_and_alignment(
            pod5_read_record=pod5_reads[comp_read_id],
            alignment_record=comp_align,
        )
        return (temp_io_read, comp_io_read), None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
