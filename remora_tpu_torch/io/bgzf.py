"""BGZF (blocked gzip) reader/writer.

Standalone implementation of the htslib BGZF container used by BAM
(SAM spec section 4.1): a series of gzip members, each carrying a BC
extra subfield with the compressed block size, ending with a fixed
28-byte EOF member. Supports htslib-style virtual offsets
(``coffset << 16 | uoffset``) for random access, as used by the
read-indexed BAM (reference analog: pysam tell/seek in
``src/remora/io.py:255–332``).

Copy of ``remora_tpu/io/bgzf.py``, importing this package's modules.
"""

import struct
import zlib

from remora_tpu_torch import RemoraError

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HDR = struct.Struct("<4BI2B2H")  # magic..XLEN


def _read_block_size(buf, off):
    """Parse one gzip member header at ``off``; return (bsize, data_start)."""
    if buf[off : off + 2] != b"\x1f\x8b":
        raise RemoraError("Invalid BGZF block magic")
    xlen = struct.unpack_from("<H", buf, off + 10)[0]
    extra_end = off + 12 + xlen
    p = off + 12
    bsize = None
    while p < extra_end:
        si1, si2, slen = buf[p], buf[p + 1], struct.unpack_from("<H", buf, p + 2)[0]
        if si1 == 66 and si2 == 67:  # 'B','C'
            bsize = struct.unpack_from("<H", buf, p + 4)[0] + 1
        p += 4 + slen
    if bsize is None:
        raise RemoraError("BGZF block missing BC extra field")
    return bsize, extra_end


class BgzfReader:
    """Random-access BGZF reader over an in-memory or mmap'd file.

    The whole compressed file is held as a buffer (BAM files of interest
    are far smaller than host RAM; an mmap can be passed for huge files).
    Decompressed blocks are cached LRU-style.
    """

    def __init__(self, path, cache_blocks=512):
        with open(path, "rb") as fh:
            self._buf = fh.read()
        self._cache = {}
        self._cache_order = []
        self._cache_blocks = cache_blocks
        # current virtual position
        self._coffset = 0
        self._uoffset = 0
        self._block = None
        self._block_len = 0
        self._next_coffset = 0

    def _load_block(self, coffset):
        blk = self._cache.get(coffset)
        if blk is None:
            if coffset >= len(self._buf):
                return b"", coffset
            bsize, data_start = _read_block_size(self._buf, coffset)
            comp = self._buf[data_start : coffset + bsize - 8]
            data = zlib.decompress(comp, wbits=-15)
            blk = (data, coffset + bsize)
            self._cache[coffset] = blk
            self._cache_order.append(coffset)
            if len(self._cache_order) > self._cache_blocks:
                evict = self._cache_order.pop(0)
                if evict != coffset:
                    self._cache.pop(evict, None)
        return blk

    def tell(self):
        """Current virtual offset."""
        return (self._coffset << 16) | self._uoffset

    def seek(self, voffset):
        self._coffset = voffset >> 16
        self._uoffset = voffset & 0xFFFF
        self._block = None
        return voffset

    def _ensure_block(self):
        if self._block is None:
            data, nxt = self._load_block(self._coffset)
            self._block = data
            self._block_len = len(data)
            self._next_coffset = nxt
        # advance over exhausted blocks
        while self._uoffset >= self._block_len:
            if self._block_len == 0:
                return False  # EOF
            self._coffset = self._next_coffset
            self._uoffset = 0
            data, nxt = self._load_block(self._coffset)
            self._block = data
            self._block_len = len(data)
            self._next_coffset = nxt
        return self._block_len > 0

    def read(self, n):
        out = bytearray()
        while n > 0:
            if not self._ensure_block():
                break
            avail = self._block_len - self._uoffset
            take = min(avail, n)
            out += self._block[self._uoffset : self._uoffset + take]
            self._uoffset += take
            n -= take
        return bytes(out)

    def at_eof(self):
        return not self._ensure_block()


def decompress_all(path_or_bytes):
    """Decompress an entire BGZF file to one bytes object (fast path for
    full scans; zlib handles concatenated members)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        raw = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as fh:
            raw = fh.read()
    out = []
    d = zlib.decompressobj(wbits=31)
    while raw:
        out.append(d.decompress(raw))
        raw = d.unused_data
        if raw:
            d = zlib.decompressobj(wbits=31)
    return b"".join(out)


class BgzfWriter:
    """Streaming BGZF writer producing <=64KiB blocks plus the EOF marker."""

    MAX_BLOCK = 0xFF00  # uncompressed payload per block

    def __init__(self, path, compresslevel=6):
        self._fh = open(path, "wb")
        self._level = compresslevel
        self._pending = bytearray()

    def write(self, data):
        self._pending += data
        while len(self._pending) >= self.MAX_BLOCK:
            self._flush_block(self._pending[: self.MAX_BLOCK])
            del self._pending[: self.MAX_BLOCK]

    def _flush_block(self, payload):
        payload = bytes(payload)
        c = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        comp = c.compress(payload) + c.flush()
        bsize = len(comp) + 25 + 1
        if bsize > 0x10000:
            # incompressible payload: store with level 0
            c = zlib.compressobj(0, zlib.DEFLATED, -15)
            comp = c.compress(payload) + c.flush()
            bsize = len(comp) + 25 + 1
        header = (
            b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", 6)
            + b"BC"
            + struct.pack("<H", 2)
            + struct.pack("<H", bsize - 1)
        )
        footer = struct.pack(
            "<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload)
        )
        self._fh.write(header + comp + footer)

    def close(self):
        if self._fh is None:
            return
        if self._pending:
            self._flush_block(self._pending)
            self._pending = bytearray()
        self._fh.write(BGZF_EOF)
        self._fh.close()
        self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
