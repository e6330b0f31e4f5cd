"""Native BAM reader/writer (SAM spec v1.6 section 4), no htslib/pysam.

Provides the pieces the framework needs from BAM:
  * streaming record iteration with virtual-offset ``tell`` for the
    read-id index (reference analog ``src/remora/io.py:183–359``)
  * full record decode: name, flags, cigar, seq, qual, typed tags
  * reference-sequence reconstruction from the MD tag (pysam
    ``get_reference_sequence`` analog)
  * record write-back with added/replaced tags for modBAM output

Copy of ``remora_tpu/io/bam.py``, importing this package's modules.
"""

import struct
from dataclasses import dataclass, field

import numpy as np

from remora_tpu_torch import RemoraError
from remora_tpu_torch.core.coords import cigartuples_to_string
from remora_tpu_torch.io.bgzf import BgzfReader, BgzfWriter, decompress_all

BAM_MAGIC = b"BAM\x01"
SEQ_NIBBLE = "=ACMGRSVTWYHKDBN"
_NIBBLE_CODE = {c: i for i, c in enumerate(SEQ_NIBBLE)}
_NIBBLE_CODE["N"] = 15

# flag bits
FPAIRED = 0x1
FUNMAP = 0x4
FREVERSE = 0x10
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800

_TAG_FMT = {
    ord("c"): ("<b", 1),
    ord("C"): ("<B", 1),
    ord("s"): ("<h", 2),
    ord("S"): ("<H", 2),
    ord("i"): ("<i", 4),
    ord("I"): ("<I", 4),
    ord("f"): ("<f", 4),
}
_ARRAY_DTYPE = {
    "c": np.int8,
    "C": np.uint8,
    "s": np.int16,
    "S": np.uint16,
    "i": np.int32,
    "I": np.uint32,
    "f": np.float32,
}


def _decode_seq(packed, l_seq):
    if l_seq == 0:
        return ""
    nib = np.frombuffer(packed, dtype=np.uint8)
    out = np.empty(nib.size * 2, dtype=np.uint8)
    lut = np.frombuffer(SEQ_NIBBLE.encode(), dtype=np.uint8)
    out[0::2] = lut[nib >> 4]
    out[1::2] = lut[nib & 0xF]
    return out[:l_seq].tobytes().decode("ascii")


def _encode_seq(seq):
    if len(seq) == 0:
        return b""
    codes = np.array([_NIBBLE_CODE.get(c.upper(), 15) for c in seq], dtype=np.uint8)
    if codes.size % 2:
        codes = np.append(codes, 0)
    return ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()


def _parse_tags(buf, p, end):
    """Decode the auxiliary field region; returns ordered list of
    (tag, type_char, value)."""
    tags = []
    while p < end:
        tag = buf[p : p + 2].decode("ascii")
        tc = buf[p + 2]
        p += 3
        if tc == ord("A"):
            tags.append((tag, "A", chr(buf[p])))
            p += 1
        elif tc in _TAG_FMT:
            fmt, sz = _TAG_FMT[tc]
            tags.append((tag, chr(tc), struct.unpack_from(fmt, buf, p)[0]))
            p += sz
        elif tc in (ord("Z"), ord("H")):
            z = buf.index(b"\x00", p)
            tags.append((tag, chr(tc), buf[p:z].decode("ascii")))
            p = z + 1
        elif tc == ord("B"):
            sub = chr(buf[p])
            cnt = struct.unpack_from("<I", buf, p + 1)[0]
            dt = _ARRAY_DTYPE[sub]
            nbytes = cnt * np.dtype(dt).itemsize
            arr = np.frombuffer(buf[p + 5 : p + 5 + nbytes], dtype=dt)
            tags.append((tag, "B" + sub, arr))
            p += 5 + nbytes
        else:
            raise RemoraError(f"Unknown BAM tag type {chr(tc)!r} for tag {tag}")
    return tags


def _encode_tags(tags):
    out = bytearray()
    for tag, tc, val in tags:
        out += tag.encode("ascii")
        if tc == "A":
            out += b"A" + val.encode("ascii")
        elif tc in "cCsSiIf":
            out += tc.encode("ascii")
            out += struct.pack(_TAG_FMT[ord(tc)][0], val)
        elif tc in "ZH":
            out += tc.encode("ascii") + str(val).encode("ascii") + b"\x00"
        elif tc.startswith("B"):
            sub = tc[1]
            arr = np.asarray(val, dtype=_ARRAY_DTYPE[sub])
            out += b"B" + sub.encode("ascii") + struct.pack("<I", arr.size)
            out += arr.tobytes()
        else:
            raise RemoraError(f"Unknown tag type {tc!r}")
    return bytes(out)


def reg2bin(beg, end):
    """BAI/CSI bin number for a [beg, end) interval (SAM spec 5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


@dataclass
class BamRecord:
    """One decoded BAM alignment record."""

    query_name: str
    flag: int
    reference_id: int
    reference_start: int
    mapq: int
    cigartuples: list
    next_reference_id: int = -1
    next_reference_start: int = -1
    template_length: int = 0
    query_sequence: str = None
    query_qualities: np.ndarray = None
    tags: list = field(default_factory=list)  # (tag, type_char, value)
    header: "BamHeader" = None

    # --- flags ---
    @property
    def is_unmapped(self):
        return bool(self.flag & FUNMAP)

    @property
    def is_mapped(self):
        return not self.is_unmapped

    @property
    def is_reverse(self):
        return bool(self.flag & FREVERSE)

    @property
    def is_forward(self):
        return not self.is_reverse

    @property
    def is_secondary(self):
        return bool(self.flag & FSECONDARY)

    @property
    def is_supplementary(self):
        return bool(self.flag & FSUPPLEMENTARY)

    @property
    def reference_name(self):
        if self.reference_id < 0 or self.header is None:
            return None
        return self.header.references[self.reference_id]

    # --- tags ---
    def get_tag(self, tag):
        for t, _tc, v in self.tags:
            if t == tag:
                return v
        raise KeyError(tag)

    def has_tag(self, tag):
        return any(t == tag for t, _tc, _v in self.tags)

    def tag_dict(self):
        return {t: v for t, _tc, v in self.tags}

    def set_tag(self, tag, type_char, value):
        self.tags = [t for t in self.tags if t[0] != tag]
        self.tags.append((tag, type_char, value))

    def drop_tags(self, names):
        self.tags = [t for t in self.tags if t[0] not in names]

    # --- derived coordinates ---
    @property
    def reference_length(self):
        from remora_tpu_torch.core.coords import REF_OPS

        if self.cigartuples is None:
            return 0
        return sum(ln for op, ln in self.cigartuples if REF_OPS[op])

    @property
    def reference_end(self):
        return self.reference_start + self.reference_length

    def get_reference_sequence(self):
        """Reconstruct the aligned reference sequence from MD + SEQ.

        Mirrors pysam's get_reference_sequence (requires the MD tag):
        walks the cigar to build the matched-query skeleton then applies
        MD mismatches and deletions.
        """
        try:
            md = self.get_tag("MD")
        except KeyError:
            raise ValueError("MD tag not present")
        if self.query_sequence is None:
            raise ValueError("Query sequence required to rebuild reference")
        # gather reference-consuming sequence from query (M/=/X copy query,
        # D/N gap placeholder filled from MD)
        ref_parts = []
        qpos = 0
        for op, ln in self.cigartuples:
            if op in (0, 7, 8):  # M,=,X
                ref_parts.append(list(self.query_sequence[qpos : qpos + ln]))
                qpos += ln
            elif op in (1, 4):  # I,S consume query only
                qpos += ln
            elif op in (2, 3):  # D,N consume ref only
                ref_parts.append([None] * ln)
        ref = [c for part in ref_parts for c in part]
        # apply MD string
        i = 0  # position in ref
        p = 0
        md_len = len(md)
        while p < md_len:
            c = md[p]
            if c.isdigit():
                j = p
                while j < md_len and md[j].isdigit():
                    j += 1
                i += int(md[p:j])
                p = j
            elif c == "^":
                p += 1
                while p < md_len and md[p].isalpha():
                    ref[i] = md[p]
                    i += 1
                    p += 1
            else:  # mismatch: MD letter is the reference base
                ref[i] = c
                i += 1
                p += 1
        if any(c is None for c in ref):
            raise ValueError("MD tag inconsistent with cigar")
        return "".join(ref)

    def get_aligned_pairs(self, with_seq=False):
        """(query_pos, ref_pos[, ref_base]) per alignment column (pysam
        semantics; ref bases require the MD tag when with_seq)."""
        ref_seq = self.get_reference_sequence() if with_seq else None
        pairs = []
        qpos = 0
        rpos = self.reference_start
        roff = 0
        for op, ln in self.cigartuples or []:
            if op in (0, 7, 8):  # M,=,X
                for k in range(ln):
                    if with_seq:
                        pairs.append((qpos + k, rpos + k, ref_seq[roff + k]))
                    else:
                        pairs.append((qpos + k, rpos + k))
                qpos += ln
                rpos += ln
                roff += ln
            elif op in (1, 4):  # I,S consume query
                for k in range(ln):
                    pairs.append(
                        (qpos + k, None, None) if with_seq else (qpos + k, None)
                    )
                qpos += ln
            elif op in (2, 3):  # D,N consume ref
                for k in range(ln):
                    if with_seq:
                        pairs.append((None, rpos + k, ref_seq[roff + k]))
                    else:
                        pairs.append((None, rpos + k))
                rpos += ln
                roff += ln
            # H,P consume neither
        return pairs

    @property
    def query_alignment_start(self):
        qpos = 0
        for op, ln in self.cigartuples or []:
            if op in (4, 1):
                qpos += ln
            elif op == 5:
                continue
            else:
                break
        return qpos

    @property
    def query_alignment_end(self):
        qpos = len(self.query_sequence or "")
        for op, ln in reversed(self.cigartuples or []):
            if op in (4, 1):
                qpos -= ln
            elif op == 5:
                continue
            else:
                break
        return qpos

    @property
    def modified_bases(self):
        """Parse MM/ML tags (pysam-compatible).

        Returns {(canonical_base, mod_strand, mod_name): [(qpos, qual)]}
        with positions in query_sequence (stored SEQ) coordinates and
        mod_strand 0 for '+', 1 for '-'. None when no MM tag present.
        """
        try:
            mm = self.get_tag("MM")
        except KeyError:
            try:
                mm = self.get_tag("Mm")
            except KeyError:
                return None
        try:
            ml = self.get_tag("ML")
        except KeyError:
            try:
                ml = self.get_tag("Ml")
            except KeyError:
                ml = None
        if self.query_sequence is None:
            return None
        seq = self.query_sequence
        # original read orientation sequence
        if self.is_reverse:
            comp = str.maketrans("ACGTN", "TGCAN")
            orig_seq = seq.translate(comp)[::-1]
        else:
            orig_seq = seq
        out = {}
        ml_idx = 0
        for item in mm.rstrip(";").split(";"):
            if not item:
                continue
            head, *deltas = item.split(",")
            # head like C+m? or C+mh. or with ChEBI numbers C+76792?
            can_base = head[0]
            strand_ch = head[1]
            body = head[2:]
            if body and body[-1] in "?.":
                body = body[:-1]
            # mods may be multi-letter ChEBI codes (digits) or 1-letter runs
            if body.isdigit():
                mod_names = [body]
            else:
                mod_names = list(body)
            deltas = [int(d) for d in deltas]
            # positions of can_base in the original-orientation read
            base_idx = [
                i for i, b in enumerate(orig_seq) if b == can_base
            ]
            mod_poss = []
            cum = -1
            ok = True
            for d in deltas:
                cum += d + 1
                if cum >= len(base_idx):
                    ok = False
                    break
                mod_poss.append(base_idx[cum])
            if not ok:
                ml_idx += len(deltas) * len(mod_names)
                continue
            for pos_i, orig_pos in enumerate(mod_poss):
                qpos = (
                    orig_pos
                    if not self.is_reverse
                    else len(seq) - 1 - orig_pos
                )
                for mod_i, mod_name in enumerate(mod_names):
                    qual = (
                        int(ml[ml_idx + pos_i * len(mod_names) + mod_i])
                        if ml is not None
                        else -1
                    )
                    # strand reported relative to the aligned orientation
                    # (tag strand XOR is_reverse), matching pysam/htslib
                    tag_strand = 0 if strand_ch == "+" else 1
                    key = (
                        can_base,
                        tag_strand ^ int(self.is_reverse),
                        mod_name,
                    )
                    out.setdefault(key, []).append((qpos, qual))
            ml_idx += len(mod_poss) * len(mod_names)
        return out

    # --- encoding ---
    def encode(self, header=None):
        header = header or self.header
        name = self.query_name.encode("ascii") + b"\x00"
        cigar = self.cigartuples or []
        if len(cigar) > 0xFFFF:
            raise RemoraError("Long cigars (>65535 ops) not supported yet")
        seq = self.query_sequence or ""
        l_seq = len(seq)
        cig_bytes = b"".join(
            struct.pack("<I", (ln << 4) | op) for op, ln in cigar
        )
        if self.query_qualities is None:
            qual_bytes = b"\xff" * l_seq
        else:
            qual_bytes = np.asarray(
                self.query_qualities, dtype=np.uint8
            ).tobytes()
        rec = struct.pack(
            "<iiBBHHHiiii",
            self.reference_id,
            self.reference_start,
            len(name),
            self.mapq,
            reg2bin(self.reference_start, max(self.reference_end,
                                              self.reference_start + 1)),
            len(cigar),
            self.flag,
            l_seq,
            self.next_reference_id,
            self.next_reference_start,
            self.template_length,
        )
        body = rec + name + cig_bytes + _encode_seq(seq) + qual_bytes
        body += _encode_tags(self.tags)
        return struct.pack("<i", len(body)) + body

    def to_sam_line(self, header=None):
        header = header or self.header
        rname = self.reference_name or "*"
        cigar = (
            cigartuples_to_string(self.cigartuples) if self.cigartuples else "*"
        )
        seq = self.query_sequence or "*"
        if self.query_qualities is None:
            qual = "*"
        else:
            qual = "".join(chr(q + 33) for q in self.query_qualities)
        fields = [
            self.query_name,
            str(self.flag),
            rname,
            str(self.reference_start + 1),
            str(self.mapq),
            cigar,
            "*",
            "0",
            str(self.template_length),
            seq,
            qual,
        ]
        for tag, tc, val in self.tags:
            if tc == "A":
                fields.append(f"{tag}:A:{val}")
            elif tc in "cCsSiI":
                fields.append(f"{tag}:i:{val}")
            elif tc == "f":
                fields.append(f"{tag}:f:{val}")
            elif tc in "ZH":
                fields.append(f"{tag}:{tc}:{val}")
            elif tc.startswith("B"):
                vals = ",".join(map(str, np.asarray(val).tolist()))
                fields.append(f"{tag}:B:{tc[1]},{vals}")
        return "\t".join(fields)


def decode_record(buf, header=None):
    """Decode one record body (without the leading block_size int)."""
    (
        ref_id,
        pos,
        l_read_name,
        mapq,
        _bin,
        n_cigar,
        flag,
        l_seq,
        next_ref,
        next_pos,
        tlen,
    ) = struct.unpack_from("<iiBBHHHiiii", buf, 0)
    p = 32
    qname = buf[p : p + l_read_name - 1].decode("ascii")
    p += l_read_name
    cigar = []
    for _ in range(n_cigar):
        v = struct.unpack_from("<I", buf, p)[0]
        cigar.append((v & 0xF, v >> 4))
        p += 4
    seq = _decode_seq(buf[p : p + (l_seq + 1) // 2], l_seq)
    p += (l_seq + 1) // 2
    qual = np.frombuffer(buf[p : p + l_seq], dtype=np.uint8)
    if l_seq and qual.size and qual[0] == 0xFF:
        qual = None
    p += l_seq
    tags = _parse_tags(buf, p, len(buf))
    return BamRecord(
        query_name=qname,
        flag=flag,
        reference_id=ref_id,
        reference_start=pos,
        mapq=mapq,
        cigartuples=cigar if n_cigar else None,
        next_reference_id=next_ref,
        next_reference_start=next_pos,
        template_length=tlen,
        query_sequence=seq if l_seq else None,
        query_qualities=qual,
        tags=tags,
        header=header,
    )


@dataclass
class BamHeader:
    text: str
    references: list
    lengths: list

    def encode(self):
        out = BAM_MAGIC
        text = self.text.encode("ascii")
        out += struct.pack("<i", len(text)) + text
        out += struct.pack("<i", len(self.references))
        for name, ln in zip(self.references, self.lengths):
            nb = name.encode("ascii") + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
        return out


class BamReader:
    """Sequential/random-access BAM reader with virtual offsets."""

    def __init__(self, path):
        self.path = str(path)
        self._bgzf = BgzfReader(self.path)
        magic = self._bgzf.read(4)
        if magic != BAM_MAGIC:
            raise RemoraError(f"Not a BAM file: {path}")
        (l_text,) = struct.unpack("<i", self._bgzf.read(4))
        text = self._bgzf.read(l_text).rstrip(b"\x00").decode("ascii")
        (n_ref,) = struct.unpack("<i", self._bgzf.read(4))
        refs, lens = [], []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._bgzf.read(4))
            refs.append(self._bgzf.read(l_name)[:-1].decode("ascii"))
            lens.append(struct.unpack("<i", self._bgzf.read(4))[0])
        self.header = BamHeader(text, refs, lens)
        self._body_voffset = self._bgzf.tell()

    def tell(self):
        return self._bgzf.tell()

    def seek(self, voffset):
        self._bgzf.seek(voffset)

    def rewind(self):
        self._bgzf.seek(self._body_voffset)

    def read_record(self):
        """Read the record at the current position or None at EOF."""
        size_b = self._bgzf.read(4)
        if len(size_b) < 4:
            return None
        (block_size,) = struct.unpack("<i", size_b)
        body = self._bgzf.read(block_size)
        if len(body) < block_size:
            raise RemoraError("Truncated BAM record")
        return decode_record(body, self.header)

    def __iter__(self):
        self.rewind()
        while True:
            rec = self.read_record()
            if rec is None:
                return
            yield rec

    def iter_with_offsets(self):
        """Yield (virtual_offset, record) over the whole file."""
        self.rewind()
        while True:
            ptr = self._bgzf.tell()
            rec = self.read_record()
            if rec is None:
                return
            yield ptr, rec


class FastBamScanner:
    """One-shot full-file scan decompressing the entire BGZF stream first.

    Much faster than block-at-a-time access for the initial whole-file
    index pass; yields pseudo-offsets that are indices into the
    decompressed stream. Use ``BamReader`` when htslib-compatible virtual
    offsets are required; the read index (io.read_index) only needs
    self-consistent offsets so it uses this scanner with its own
    coordinate space.
    """

    def __init__(self, path):
        self.path = str(path)
        self._data = decompress_all(self.path)
        buf = self._data
        if buf[:4] != BAM_MAGIC:
            raise RemoraError(f"Not a BAM file: {path}")
        (l_text,) = struct.unpack_from("<i", buf, 4)
        text = buf[8 : 8 + l_text].rstrip(b"\x00").decode("ascii")
        p = 8 + l_text
        (n_ref,) = struct.unpack_from("<i", buf, p)
        p += 4
        refs, lens = [], []
        for _ in range(n_ref):
            (l_name,) = struct.unpack_from("<i", buf, p)
            p += 4
            refs.append(buf[p : p + l_name - 1].decode("ascii"))
            p += l_name
            lens.append(struct.unpack_from("<i", buf, p)[0])
            p += 4
        self.header = BamHeader(text, refs, lens)
        self._body_start = p

    def iter_with_offsets(self):
        buf = self._data
        p = self._body_start
        n = len(buf)
        while p + 4 <= n:
            (block_size,) = struct.unpack_from("<i", buf, p)
            body = buf[p + 4 : p + 4 + block_size]
            yield p, decode_record(body, self.header)
            p += 4 + block_size

    def record_at(self, offset):
        (block_size,) = struct.unpack_from("<i", self._data, offset)
        return decode_record(
            self._data[offset + 4 : offset + 4 + block_size], self.header
        )

    def __iter__(self):
        for _off, rec in self.iter_with_offsets():
            yield rec


class BamWriter:
    """BGZF-compressed BAM writer."""

    def __init__(self, path, header, compresslevel=6):
        self.header = header
        self._w = BgzfWriter(path, compresslevel=compresslevel)
        self._w.write(header.encode())

    def write(self, record):
        self._w.write(record.encode(self.header))

    def close(self):
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def get_bam_filename(bam_fh):
    """Filename behind an open BAM handle/scanner (reference analog
    ``io.get_bam_filename`` io.py:167–171)."""
    for attr in ("reference_filename", "filename", "path"):
        val = getattr(bam_fh, attr, None)
        if val is not None:
            return val.decode() if isinstance(val, bytes) else str(val)
