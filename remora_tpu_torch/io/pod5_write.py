"""POD5 writer (reader counterpart in remora_tpu_torch.io.pod5).

Writes the combined POD5 container: signature + section marker, three
embedded Arrow IPC files (vbz-compressed signal table, run-info table,
reads table) and the footer flatbuffer locating them. Covers the column
subset the framework (and its reader) uses; used for synthetic test
data generation and dataset tooling.

Copy of ``remora_tpu/io/pod5_write.py``, importing this package's
modules; the default ``software`` string names this package.
"""

import struct
import uuid as uuid_mod

import numpy as np

from remora_tpu_torch import log
from remora_tpu_torch.io.pod5 import POD5_SIGNATURE, vbz_encode

LOGGER = log.get_logger()

_CONTENT_READS = 0
_CONTENT_SIGNAL = 1
_CONTENT_RUN_INFO = 4
_FORMAT_FEATHER = 2

SIGNAL_CHUNK = 102_400  # samples per signal-table row (pod5 default)


def _build_footer(file_identifier, software, version, contents):
    """Hand-assembled flatbuffer matching ``io.pod5.parse_footer``.

    Forward layout (uoffsets are unsigned and point to higher addresses):
    root uoffset -> root vtable/table -> strings -> contents vector ->
    EmbeddedFile tables -> EmbeddedFile vtable (soffset is signed, so the
    shared vtable may live after its tables).

    contents: list of (offset, length, content_type).
    """
    buf = bytearray()

    def pad_to(align):
        while len(buf) % align:
            buf.append(0)

    buf += b"\x00\x00\x00\x00"  # root uoffset placeholder

    # root vtable: 4 uoffset fields at table offsets 4, 8, 12, 16
    root_vt_pos = len(buf)
    buf += struct.pack("<HHHHHH", 12, 20, 4, 8, 12, 16)
    root_pos = len(buf)
    buf += struct.pack("<i", root_pos - root_vt_pos)
    root_field_pos = len(buf)
    buf += b"\x00" * 16  # 4 uoffset placeholders
    struct.pack_into("<I", buf, 0, root_pos)

    def put_string(s):
        pad_to(4)
        pos = len(buf)
        data = s.encode()
        buf.extend(struct.pack("<I", len(data)))
        buf.extend(data)
        buf.append(0)
        return pos

    string_positions = [
        put_string(file_identifier),
        put_string(software),
        put_string(version),
    ]

    pad_to(4)
    vec_pos = len(buf)
    buf += struct.pack("<I", len(contents)) + b"\x00" * (4 * len(contents))
    vec_elem_base = vec_pos + 4

    # fill root table fields (all forward)
    for i, target in enumerate(string_positions + [vec_pos]):
        struct.pack_into(
            "<I", buf, root_field_pos + 4 * i, target - (root_field_pos + 4 * i)
        )

    # EmbeddedFile tables: [soffset i32][offset i64][length i64]
    #                      [format i16][content_type i16]
    ef_positions = []
    for off, length, ctype in contents:
        # align so the i64 fields at table+4 are 8B aligned
        if (len(buf) + 4) % 8:
            buf += b"\x00" * (8 - ((len(buf) + 4) % 8))
        tpos = len(buf)
        buf += b"\x00" * 4  # soffset placeholder
        buf += struct.pack("<q", off)
        buf += struct.pack("<q", length)
        buf += struct.pack("<h", _FORMAT_FEATHER)
        buf += struct.pack("<h", ctype)
        ef_positions.append(tpos)
    # shared EmbeddedFile vtable after the tables (soffset is signed)
    pad_to(4)
    ef_vt_pos = len(buf)
    buf += struct.pack("<HHHHHH", 12, 24, 4, 12, 20, 22)
    for tpos in ef_positions:
        struct.pack_into("<i", buf, tpos, tpos - ef_vt_pos)
    for i, tpos in enumerate(ef_positions):
        elem_pos = vec_elem_base + 4 * i
        struct.pack_into("<I", buf, elem_pos, tpos - elem_pos)
    return bytes(buf)


class Pod5Writer:
    """Write reads (signal + calibration) into one POD5 file.

    Calibration follows the package's convention
    (pA = (dac - offset) / scale, see io.pod5.Calibration); values are
    stored in the file in the raw pod5 form.
    """

    def __init__(self, path, sample_rate=4000, software="remora_tpu_torch"):
        self.path = str(path)
        self.sample_rate = sample_rate
        self.software = software
        self._reads = []

    def add_read(self, read_id, signal, calibration_offset, calibration_scale):
        """Append one read.

        Args:
            read_id: uuid string
            signal: int16 DACs
            calibration_offset/scale: shift/scale form
                (pA = (dac - offset) / scale)
        """
        self._reads.append(
            (
                str(read_id),
                np.asarray(signal, np.int16),
                float(calibration_offset),
                float(calibration_scale),
            )
        )

    def close(self):
        import pyarrow as pa
        import pyarrow.ipc as ipc

        file_identifier = str(uuid_mod.uuid4())
        meta = {
            b"MINKNOW:file_identifier": file_identifier.encode(),
            b"MINKNOW:software": self.software.encode(),
            b"MINKNOW:pod5_version": b"0.1.4",
        }

        # --- signal table ---
        sig_ids, sig_rows, sig_samples = [], [], []
        read_sig_rows = []
        for rid, signal, _o, _s in self._reads:
            rows = []
            for st in range(0, max(signal.size, 1), SIGNAL_CHUNK):
                chunk = signal[st : st + SIGNAL_CHUNK]
                rows.append(len(sig_rows))
                sig_ids.append(uuid_mod.UUID(rid).bytes)
                sig_rows.append(vbz_encode(chunk))
                sig_samples.append(len(chunk))
            read_sig_rows.append(rows)
        signal_field = pa.field(
            "signal",
            pa.large_binary(),
            metadata={
                b"ARROW:extension:metadata": b"",
                b"ARROW:extension:name": b"minknow.vbz",
            },
        )
        rid_field = pa.field(
            "read_id",
            pa.binary(16),
            metadata={
                b"ARROW:extension:metadata": b"",
                b"ARROW:extension:name": b"minknow.uuid",
            },
        )
        signal_schema = pa.schema(
            [rid_field, signal_field, pa.field("samples", pa.uint32())],
            metadata=meta,
        )
        signal_tbl = pa.table(
            {
                "read_id": pa.array(sig_ids, pa.binary(16)),
                "signal": pa.array(sig_rows, pa.large_binary()),
                "samples": pa.array(sig_samples, pa.uint32()),
            },
            schema=signal_schema,
        )

        # --- run info table ---
        run_schema = pa.schema(
            [
                pa.field("acquisition_id", pa.string()),
                pa.field("sample_rate", pa.uint16()),
            ],
            metadata=meta,
        )
        run_tbl = pa.table(
            {
                "acquisition_id": pa.array([file_identifier]),
                "sample_rate": pa.array([self.sample_rate], pa.uint16()),
            },
            schema=run_schema,
        )

        # --- reads table ---
        reads_schema = pa.schema(
            [
                rid_field,
                pa.field("signal", pa.list_(pa.uint64())),
                pa.field("num_samples", pa.uint64()),
                pa.field("calibration_offset", pa.float32()),
                pa.field("calibration_scale", pa.float32()),
            ],
            metadata=meta,
        )
        reads_tbl = pa.table(
            {
                "read_id": pa.array(
                    [uuid_mod.UUID(r[0]).bytes for r in self._reads],
                    pa.binary(16),
                ),
                "signal": pa.array(
                    read_sig_rows, pa.list_(pa.uint64())
                ),
                "num_samples": pa.array(
                    [r[1].size for r in self._reads], pa.uint64()
                ),
                # store raw pod5 convention: pA = (dac + raw_off) * raw_scale
                "calibration_offset": pa.array(
                    [-r[2] for r in self._reads], pa.float32()
                ),
                "calibration_scale": pa.array(
                    [1.0 / r[3] for r in self._reads], pa.float32()
                ),
            },
            schema=reads_schema,
        )

        def arrow_bytes(tbl):
            sink = pa.BufferOutputStream()
            with ipc.new_file(sink, tbl.schema) as writer:
                writer.write_table(tbl)
            return sink.getvalue().to_pybytes()

        marker = uuid_mod.uuid4().bytes
        out = bytearray()
        out += POD5_SIGNATURE
        out += marker
        contents = []
        for tbl, ctype in (
            (signal_tbl, _CONTENT_SIGNAL),
            (run_tbl, _CONTENT_RUN_INFO),
            (reads_tbl, _CONTENT_READS),
        ):
            while len(out) % 8:
                out.append(0)
            data = arrow_bytes(tbl)
            contents.append((len(out), len(data), ctype))
            out += data
        while len(out) % 8:
            out.append(0)
        footer = _build_footer(
            file_identifier, self.software, "0.2.8", contents
        )
        out += footer
        out += struct.pack("<q", len(footer))
        out += marker
        out += POD5_SIGNATURE
        with open(self.path, "wb") as fh:
            fh.write(out)
        LOGGER.debug(
            f"Wrote POD5 with {len(self._reads)} reads to {self.path}"
        )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
