"""Native POD5 reader (no `pod5` package dependency).

POD5 is a container of Apache Arrow IPC files (signal table, run-info
table, reads table) with a trailing flatbuffer footer locating each
embedded file. Signal is compressed per-row with ONT "vbz": delta
encoding -> zigzag -> svb16 stream-variable-byte (1-bit key per element,
1-or-2-byte payload) -> zstd.

This module parses the footer flatbuffer directly, reads the embedded
tables through pyarrow, and decodes vbz with vectorized NumPy, the zstd
frames through pyarrow's codec (no ``zstandard``).

Reference analog: ``src/remora/io.py:415–520`` (iter_pod5_reads /
iter_signal via the pod5 package).

Copy of ``remora_tpu/io/pod5.py``, importing this package's modules.
"""

import struct
import uuid
from dataclasses import dataclass

import numpy as np

from remora_tpu_torch import RemoraError, log

LOGGER = log.get_logger()

POD5_SIGNATURE = b"\x8bPOD\r\n\x1a\n"

_CONTENT_READS = 0
_CONTENT_SIGNAL = 1
_CONTENT_RUN_INFO = 4


def _fb_table_fields(buf, pos):
    """Field positions of a flatbuffer table at ``pos`` (None when absent)."""
    soff = struct.unpack_from("<i", buf, pos)[0]
    vt = pos - soff
    vt_size, _tbl_size = struct.unpack_from("<HH", buf, vt)
    nfields = (vt_size - 4) // 2
    offs = struct.unpack_from(f"<{nfields}H", buf, vt + 4)
    return [pos + o if o else None for o in offs]


def parse_footer(buf):
    """Locate embedded Arrow files from the POD5 footer.

    Returns:
        list of (offset, length, content_type) tuples
    """
    if buf[:8] != POD5_SIGNATURE or buf[-8:] != POD5_SIGNATURE:
        raise RemoraError("Not a POD5 file (bad signature)")
    n = len(buf)
    footer_len = struct.unpack_from("<q", buf, n - 8 - 16 - 8)[0]
    footer = buf[n - 8 - 16 - 8 - footer_len : n - 8 - 16 - 8]
    root = struct.unpack_from("<I", footer, 0)[0]
    fields = _fb_table_fields(footer, root)
    contents_field = fields[3]
    if contents_field is None:
        raise RemoraError("POD5 footer lists no embedded files")
    vec_off = struct.unpack_from("<I", footer, contents_field)[0]
    vp = contents_field + vec_off
    count = struct.unpack_from("<I", footer, vp)[0]
    files = []
    for i in range(count):
        elem_pos = vp + 4 + 4 * i
        eo = struct.unpack_from("<I", footer, elem_pos)[0]
        efields = _fb_table_fields(footer, elem_pos + eo)
        off = struct.unpack_from("<q", footer, efields[0])[0] if efields[0] else 0
        length = (
            struct.unpack_from("<q", footer, efields[1])[0] if efields[1] else 0
        )
        ctype = 0
        if len(efields) > 3 and efields[3] is not None:
            ctype = struct.unpack_from("<h", footer, efields[3])[0]
        files.append((off, length, ctype))
    return files


_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def zstd_content_size(frame, what="a signal row"):
    """The decompressed size a zstd frame's header declares.

    Header: magic, descriptor byte (bits 7-6 the content-size flag, bit 5
    single segment, bits 1-0 the dictionary-ID flag), a window byte unless
    single segment, a 0/1/2/4-byte dictionary ID, then the content size:
    flag 0 one byte when single segment (else absent), 1 two bytes (+256),
    2 four, 3 eight. ``ZSTD_compress`` (POD5's vbz writer) always writes
    it; a frame without one raises, naming ``what``.
    """
    frame = memoryview(frame)
    if bytes(frame[:4]) != _ZSTD_MAGIC or len(frame) < 5:
        raise RemoraError(f"vbz signal of {what} is not a zstd frame")
    desc = frame[4]
    fcs_flag, single = desc >> 6, desc >> 5 & 1
    fcs_len = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if fcs_len == 0:
        raise RemoraError(
            f"vbz signal of {what}: the zstd frame declares no content size"
        )
    pos = 5 + (0 if single else 1) + (0, 1, 2, 4)[desc & 3]
    if len(frame) < pos + fcs_len:
        raise RemoraError(f"vbz signal of {what}: truncated zstd header")
    size = int.from_bytes(frame[pos : pos + fcs_len], "little")
    return size + 256 if fcs_len == 2 else size


def vbz_decode(compressed, num_samples, read_id=None):
    """Decode one vbz-compressed signal row to int16 DACs.

    The zstd frame is decoded by ``pyarrow`` at the size its header
    declares; a frame that is not zstd, declares no size, or whose size or
    payload does not hold ``num_samples`` svb16 values raises
    ``RemoraError`` naming ``read_id``.
    """
    import pyarrow as pa

    what = "a signal row" if read_id is None else f"read {read_id}"
    size = zstd_content_size(compressed, what)
    key_len = (num_samples + 7) // 8
    if not key_len + num_samples <= size <= key_len + 2 * num_samples:
        raise RemoraError(
            f"vbz signal of {what}: {size} decompressed bytes cannot hold "
            f"{num_samples} svb16 samples"
        )
    try:
        dec = pa.Codec("zstd").decompress(
            compressed, decompressed_size=size, asbytes=True
        )
        return svb16_decode(dec, num_samples)
    except (OSError, RemoraError) as err:
        raise RemoraError(f"vbz signal of {what}: {err}") from None


def svb16_decode(dec, n):
    """svb16 + zigzag + delta decode (vectorized).

    Layout: ceil(n/8) key bytes (LSB-first bits; bit=1 -> 2-byte value)
    followed by the packed little-endian payload bytes.
    """
    if n == 0:
        return np.empty(0, dtype=np.int16)
    key_len = (n + 7) // 8
    keys = np.frombuffer(dec, dtype=np.uint8, count=key_len)
    data = np.frombuffer(dec, dtype=np.uint8, offset=key_len)
    bits = np.unpackbits(keys, bitorder="little")[:n].astype(np.int64)
    offs = np.empty(n, dtype=np.int64)
    offs[0] = 0
    np.cumsum(bits[:-1] + 1, out=offs[1:])
    if offs[-1] + bits[-1] + 1 != data.size:
        raise RemoraError("vbz payload size mismatch")
    lo = data[offs].astype(np.uint16)
    hi = np.zeros(n, dtype=np.uint16)
    two = bits == 1
    hi[two] = data[offs[two] + 1]
    vals = lo | (hi << 8)
    deltas = (vals >> 1).astype(np.int16) ^ -(vals & 1).astype(np.int16)
    return np.cumsum(deltas, dtype=np.int16)


def svb16_encode(signal):
    """Inverse of svb16_decode (delta -> zigzag -> svb16 pack)."""
    signal = np.asarray(signal, dtype=np.int16)
    n = signal.size
    if n == 0:
        return b""
    deltas = np.diff(signal, prepend=signal.dtype.type(0)).astype(np.int16)
    vals = (
        (deltas.astype(np.uint16) << 1) ^ (deltas >> 15).astype(np.uint16)
    ).astype(np.uint16)
    two = vals > 0xFF
    key_bits = np.zeros(((n + 7) // 8) * 8, dtype=np.uint8)
    key_bits[:n] = two
    keys = np.packbits(key_bits, bitorder="little")
    lens = 1 + two.astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    data = np.zeros(int(lens.sum()), dtype=np.uint8)
    data[offs] = vals & 0xFF
    data[offs[two] + 1] = vals[two] >> 8
    return keys.tobytes() + data.tobytes()


def vbz_encode(signal):
    """vbz-compress int16 DACs: svb16, then one zstd frame (level 1) that
    declares its content size."""
    import pyarrow as pa

    return pa.Codec("zstd", compression_level=1).compress(
        svb16_encode(signal), asbytes=True
    )


@dataclass
class Calibration:
    """DAC -> picoamp conversion in shift/scale form: pA = (dac - offset) / scale.

    The POD5 reads table stores (raw_offset, raw_scale) with
    pA = (dac + raw_offset) * raw_scale; we expose offset = -raw_offset and
    scale = 1/raw_scale so downstream code applies one uniform
    (x - shift) / scale convention (verified against the sm/sd BAM tags on
    the reference test data: pA medians match ``sm`` within noise).
    """

    offset: float
    scale: float


@dataclass
class Pod5Read:
    """One read's signal + calibration (duck-types the pod5 ReadRecord
    attributes the pipelines touch)."""

    read_id: str
    signal: np.ndarray
    calibration: Calibration
    sample_rate: int = None
    num_samples: int = None


class Pod5Reader:
    """Reader over one POD5 file (or several via DatasetReader below)."""

    def __init__(self, path):
        import pyarrow as pa
        import pyarrow.ipc as ipc

        self.path = str(path)
        with open(self.path, "rb") as fh:
            self._buf = fh.read()
        sig_loc = reads_loc = run_loc = None
        for off, ln, ctype in parse_footer(self._buf):
            if ctype == _CONTENT_SIGNAL:
                sig_loc = (off, ln)
            elif ctype == _CONTENT_READS:
                reads_loc = (off, ln)
            elif ctype == _CONTENT_RUN_INFO:
                run_loc = (off, ln)
        if sig_loc is None or reads_loc is None:
            raise RemoraError("POD5 file missing signal or reads table")

        def _open(loc):
            off, ln = loc
            return ipc.open_file(
                pa.py_buffer(self._buf[off : off + ln])
            ).read_all()

        self._signal_tbl = _open(sig_loc)
        self._reads_tbl = _open(reads_loc)
        self._run_tbl = _open(run_loc) if run_loc is not None else None

        rt = self._reads_tbl
        rid_bytes = rt["read_id"].combine_chunks().to_pylist()
        self._read_ids = [str(uuid.UUID(bytes=b)) for b in rid_bytes]
        self._rid_to_row = {rid: i for i, rid in enumerate(self._read_ids)}
        self._sig_rows = rt["signal"].to_pylist()
        self._cal_offset = rt["calibration_offset"].to_numpy()
        self._cal_scale = rt["calibration_scale"].to_numpy()
        self._num_samples = rt["num_samples"].to_numpy()
        self._sig_samples = self._signal_tbl["samples"].to_numpy()
        self._sig_compressed = (
            self._signal_tbl.schema.field("signal").type
            == __import__("pyarrow").large_binary()
        )
        self.sample_rate = None
        if self._run_tbl is not None and self._run_tbl.num_rows > 0:
            self.sample_rate = int(self._run_tbl["sample_rate"][0].as_py())

    @property
    def read_ids(self):
        return self._read_ids

    def __len__(self):
        return len(self._read_ids)

    def _read_signal(self, sig_row_indices, read_id):
        parts = []
        for row in sig_row_indices:
            row = int(row)
            raw = self._signal_tbl["signal"][row].as_py()
            nsamp = int(self._sig_samples[row])
            if self._sig_compressed:
                parts.append(vbz_decode(raw, nsamp, read_id))
            else:
                parts.append(np.asarray(raw, dtype=np.int16))
        if len(parts) == 1:
            return parts[0]
        return np.concatenate(parts)

    def get_read(self, read_id):
        try:
            row = self._rid_to_row[read_id]
        except KeyError:
            raise RemoraError(f"Read {read_id} not found in {self.path}")
        return self._make_read(row)

    def _make_read(self, row):
        return Pod5Read(
            read_id=self._read_ids[row],
            signal=self._read_signal(
                self._sig_rows[row], self._read_ids[row]
            ),
            calibration=Calibration(
                offset=-float(self._cal_offset[row]),
                scale=1.0 / float(self._cal_scale[row]),
            ),
            sample_rate=self.sample_rate,
            num_samples=int(self._num_samples[row]),
        )

    def reads(self, selection=None, preload=None):
        """Iterate Pod5Read objects (optionally a read-id subset)."""
        if selection is None:
            for row in range(len(self._read_ids)):
                yield self._make_read(row)
        else:
            for rid in selection:
                row = self._rid_to_row.get(rid)
                if row is not None:
                    yield self._make_read(row)


class DatasetReader:
    """Multi-file POD5 reader with the same ``reads``/``read_ids`` API."""

    def __init__(self, path):
        from pathlib import Path

        path = Path(path)
        if path.is_dir():
            self._readers = [Pod5Reader(p) for p in sorted(path.glob("*.pod5"))]
        else:
            self._readers = [Pod5Reader(path)]
        if not self._readers:
            raise RemoraError(f"No POD5 files found at {path}")

    @property
    def read_ids(self):
        return [rid for rdr in self._readers for rid in rdr.read_ids]

    def reads(self, selection=None, preload=None):
        if selection is not None:
            selection = list(selection)
        for rdr in self._readers:
            if selection is None:
                yield from rdr.reads()
            else:
                present = [rid for rid in selection if rid in rdr._rid_to_row]
                yield from rdr.reads(selection=present)

    def get_read(self, read_id):
        for rdr in self._readers:
            if read_id in rdr._rid_to_row:
                return rdr.get_read(read_id)
        raise RemoraError(f"Read {read_id} not found")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
